"""Multi-card execution over ``torch.distributed`` (JAX ``parallel/``):
the data axis of the 2D run (``mesh.py``), the depth-sharded whole-volume
3D path (``halo.py``) and channel tensor parallelism for NVNet3D
(``tp.py``)."""
