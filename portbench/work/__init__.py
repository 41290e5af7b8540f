"""The yardstick's arithmetic: the card's peaks, each kernel op's work
and the kernel names it launches (``<op>.py``), and the model FLOPs of a
step (``model_flops.py``).  An op's module is found by the name of its
``<op>_roofline`` metric."""
