"""Training of the port: the train step (``train.py``), its optimizer,
clipping and schedule (``optim.py``), the epoch loop over the device
volume cache (``epoch.py``), validation (``evaluate.py``), ``stat.csv``
(``stats.py``) and checkpoints (``checkpoint.py``)."""
