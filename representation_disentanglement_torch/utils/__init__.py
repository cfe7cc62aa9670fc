"""Run utilities of the port: preemption (``preempt.py``), the step
timer (``profiling.py``) and the NIfTI volume export (``visualize.py``)."""
