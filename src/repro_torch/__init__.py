"""DisCEdge on PyTorch and CUDA: the port of the ``repro`` JAX package to
one NVIDIA H100.

It mirrors ``repro``'s layout (``models/``, ``kernels/<name>/``,
``serving/``, ``tokenizer/``) and imports nothing of it, nor JAX. Entry
points run on the card unless the caller passes ``device="cpu"``
(``repro_torch.device``)."""
