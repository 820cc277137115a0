"""What the work of a call is, counted from shapes and the call's own
inputs: the model's FLOPs (flops.py) and each kernel's least bytes and
operations (kernels.py), with the H100's published peaks (peaks.py)."""
