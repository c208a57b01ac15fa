"""Binding of the flash attention CUDA kernel (``csrc/flash_attention.cu``,
the Hopper counterpart of
``repro.kernels.flash_attention.kernel.flash_attention_pallas``).

Takes the JAX layouts as they are (the kernel maps query head h to KV head
h // G itself and masks the ragged edges, so nothing is reshaped or
padded), checks device, dtype, shape and contiguity, allocates the output
with ``torch.empty`` and launches on the current stream. The kernel itself
allocates nothing and does not synchronise.

The C entry point picks the kernel by dtype: bf16 (serving) runs
``flash_attention_mma`` on the tensor cores (``mma.sync``, f32 sums); f32
(the equivalence dtype, held to 1e-4) runs ``flash_attention_simt`` on the
f32 FMA units, since TF32 tensor-core operands cannot meet that bound."""

from __future__ import annotations

import torch

from ..build import DTYPE_CODES, check, load_library, require, stream_ptr

WHERE = "flash_attention_cuda"
HEAD_DIMS = (16, 32, 64, 112, 128, 192)


def check_linear_kv(where: str, q: torch.Tensor, k, v, named_ints) -> None:
    """Checks shared by K4 and K5: k/v (B, T, KV, Dh) beside q on its
    device and dtype, int32 position/validity arrays of the given shapes,
    everything contiguous and 16-byte aligned."""
    b, t, kvh, dh = k.shape
    require(where, q.is_cuda, "q must be a CUDA tensor")
    require(where, q.dtype in DTYPE_CODES, f"unsupported dtype {q.dtype}")
    require(where, dh in HEAD_DIMS, f"head dim {dh} not in {HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        require(where, x.device == q.device and x.dtype == q.dtype,
                f"{name} must match q's device and dtype")
        require(where, tuple(x.shape) == (b, t, kvh, dh), f"{name} shape {tuple(x.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        require(where, x.is_contiguous(), f"{name} must be contiguous")
        require(where, x.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    for name, x, shape in named_ints:
        require(where, x.device == q.device and x.dtype == torch.int32,
                f"{name} must be int32 on q's device")
        require(where, tuple(x.shape) == shape, f"{name} shape {tuple(x.shape)} != {shape}")
        require(where, x.is_contiguous(), f"{name} must be contiguous")


def flash_attention_cuda(
    q: torch.Tensor,         # (B, S, H, Dh)
    k: torch.Tensor,         # (B, T, KV, Dh)
    v: torch.Tensor,
    q_pos: torch.Tensor,     # (B, S) int32
    kv_pos: torch.Tensor,    # (B, T) int32
    kv_valid: torch.Tensor,  # (B, T) int32, nonzero = valid
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Launch K4 -> (B, S, H, Dh) in q's dtype."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    require(WHERE, k.shape[0] == b and k.shape[3] == dh, f"k shape {tuple(k.shape)}")
    require(WHERE, s > 0 and t > 0, f"empty query ({s}) or key ({t}) axis")
    require(WHERE, kvh > 0 and h % kvh == 0, f"{h} query heads over {kvh} KV heads")
    check_linear_kv(WHERE, q, k, v, (
        ("q_pos", q_pos, (b, s)), ("kv_pos", kv_pos, (b, t)), ("kv_valid", kv_valid, (b, t)),
    ))
    out = torch.empty_like(q)
    err = load_library().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        kv_valid.data_ptr(), out.data_ptr(), b, s, t, h, kvh, dh, int(window),
        float(softcap), 1.0 / (dh ** 0.5), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check(err, "repro_flash_attention")
    return out
