"""Data of the port: the HDF5 slice-block datasets (``dataset.py``), the
host loader (``loader.py``), the device volume cache (``device_store.py``)
and the synthetic phantoms (``synthetic.py``)."""
