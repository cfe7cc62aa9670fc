"""PyTorch / CUDA port of the multi-modal brain-MR representation
disentanglement system, for one NVIDIA H100.

The JAX package ``representation_disentanglement_tpu`` is the reference;
this package imports nothing of it (nor JAX) and keeps its own copies of
what it needs.  Ported so far: the missing-modality serving path
(``serve.py`` -> ``MultimodalModel.synthesize``), the train and validation
steps, and a whole training run (``main_missing.py``: data, epoch loop,
schedule, checkpoints, ``stat.csv``, preemption).  Every Pallas kernel of
the JAX package has a hand-written Hopper counterpart (``csrc/``).
"""
