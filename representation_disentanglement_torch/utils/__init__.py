"""Run utilities of the port: preemption (``preempt.py``) and the step
timer (``profiling.py``)."""
