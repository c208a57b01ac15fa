"""Hand-written Hopper (sm_90a) kernels of the port, one package per TPU
kernel of the JAX package: ``kernel.py`` binds the CUDA kernel
(``csrc/*.cu``), ``ref.py`` holds its plain PyTorch version, ``ops.py``
dispatches on the tensor's device and counts launches. No kernel has a
backward: a wrapper refuses to launch where autograd would record it
(``guard.py``)."""
