"""PyTorch / CUDA port of the multi-modal brain-MR representation
disentanglement system, for one NVIDIA H100.

The JAX package ``representation_disentanglement_tpu`` is the reference;
this package imports nothing of it (nor JAX) and keeps its own copies of
what it needs.  Ported so far: the serving path and CLI, the train,
validation and test phases in every 2D configuration (``main_missing.py``),
the whole-volume 3D path (``main_3d.py``), the modules beside
``build_model`` (``models/zcond_generator.py``, ``legacy.py``,
``legacy_generators.py``, ``resnet.py``, ``danet.py``) and the data and
result tools.  Every Pallas kernel of the JAX package has a hand-written
Hopper counterpart (``csrc/``).
"""
