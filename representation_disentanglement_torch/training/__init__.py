"""Training of the port: the train step (``train.py``) and its optimizer,
clipping and schedule (``optim.py``)."""
