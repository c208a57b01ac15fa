"""Mamba2 — state-space duality (SSD) blocks [arXiv:2405.21060], the
PyTorch counterpart of ``repro.models.ssm``.

The full-sequence forward uses the chunked SSD algorithm: a quadratic,
attention-like computation *within* chunks plus a linear recurrence of the
chunk states *across* them. Decode is the O(1) recurrent step on the
(B, H, P, N) state.

``ssd_reference`` is the plain chunked version (the JAX package's
``ssd_reference``, line for line); with the kernels, ``ssm_forward`` runs
the intra-chunk work through the hand-written SSD chunk kernel (K6,
``kernels.ssd``) instead. Dtypes are the JAX package's: the SSD runs in
f32, its outputs and the final state are cast back to the input's dtype,
and decode updates ``h`` in f32 and stores it in the state's dtype.

On DTensors (a device mesh) the SSD and the decode recurrence run on each
rank's shards with plain tensors (``_ssd_on_shards``,
``_recurrence_on_shards``): the batch over the rules' ``batch`` axes, the
SSM heads over their ``ssm_inner`` axis where they divide it, B / C whole
(one group, broadcast over the heads). Run as DTensor operators, the
chunked einsums flatten dims sharded on two mesh dims, which DTensor
shards by chunking the flattened dim.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, dtype_of, init_normal, rms_norm
from .pjit_rules import flatten, from_shards, is_dtensor, local_shard, rule_placements


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssm(cfg: ModelConfig, gen: torch.Generator, device: torch.device) -> Params:
    """One Mamba2 mixer's weights: the JAX package's shapes, dtypes and
    scales (``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16 model)."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    cdim = conv_dim(cfg)
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    return {
        "in_proj": init_normal((d, 2 * di + 2 * g * n + nh), 1.0 / np.sqrt(d), dt, gen, device),
        "conv_w": init_normal((cfg.ssm_conv, cdim), 0.2, dt, gen, device),
        "conv_b": torch.zeros((cdim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=device)),
        "D": torch.ones((nh,), dtype=f32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=device),
        "gate_norm": torch.zeros((di,), dtype=dt, device=device),
        "out_proj": init_normal((di, d), 1.0 / np.sqrt(di), dt, gen, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv_full(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. xbc: (B,L,C); w: (K,C)."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + l, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_reference(
    x: torch.Tensor,     # (B,L,H,P)
    dt: torch.Tensor,    # (B,L,H) — post-softplus
    A: torch.Tensor,     # (H,) negative
    Bv: torch.Tensor,    # (B,L,G,N)
    Cv: torch.Tensor,    # (B,L,G,N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B,H,P,N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,L,H,P), final_state (B,H,P,N)), both in
    x's dtype. Uses B/C group 0, broadcast over heads (standard Mamba2).
    DTensors run on their shards (``_ssd_on_shards``)."""
    if is_dtensor(x):
        return _ssd_on_shards(x, dt, A, Bv, Cv, chunk, h0)
    b, l, h, p = x.shape
    g, n = Bv.shape[2], Bv.shape[3]
    if l % chunk:
        raise AssertionError((l, chunk))
    nc, q = l // chunk, chunk
    f32 = torch.float32

    xc = x.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = Bv.reshape(b, nc, q, g, n).to(f32)[:, :, :, 0]           # (b,nc,q,n)
    Cc = Cv.reshape(b, nc, q, g, n).to(f32)[:, :, :, 0]

    dA = dtc * A.to(f32)                                           # (b,nc,q,h)
    dA_cs = torch.cumsum(dA, dim=2)                                # inclusive
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]        # (b,nc,i,j,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    causal = causal[None, None, :, :, None]
    # clamp BEFORE exp: masked (i < j) entries are positive and overflow
    seg = torch.where(causal, seg, torch.zeros_like(seg))
    L = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))

    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)                   # (b,nc,q,q)
    y_intra = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", cb, L, dtc, xc)

    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)          # (b,nc,q,h)
    states = torch.einsum("bcqh,bcqh,bcqn,bcqhp->bchpn", decay_to_end, dtc, Bc, xc)

    chunk_decay = torch.exp(torch.sum(dA, dim=2))                  # (b,nc,h)
    carry = h0.to(f32) if h0 is not None else torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):                                            # emit the state *before* chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (b,nc,h,p,n)

    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cc, prev_states, torch.exp(dA_cs))
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y.to(x.dtype), carry.to(x.dtype)


def _roles(pl: list, head_dim: int) -> Tuple[list, list]:
    """Which mesh dims of the placements ``pl`` cut the batch (dim 0) and
    which the heads (dim ``head_dim``)."""
    from torch.distributed.tensor import Shard

    return ([isinstance(p, Shard) and p.dim == 0 for p in pl],
            [isinstance(p, Shard) and p.dim == head_dim for p in pl])


def _operand_placements(batch: list, heads: list, head_dim: Optional[int],
                        has_batch: bool) -> list:
    """Placements of an operand whose heads are its dim ``head_dim``
    (None: it has none) and whose dim 0 is the batch where ``has_batch``:
    cut as the computation is, replicated on the other mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if b and has_batch else Shard(head_dim) if h and head_dim is not None
            else Replicate() for b, h in zip(batch, heads)]


def _ssd_on_shards(x, dt, A, Bv, Cv, chunk: int, h0):
    """``ssd_reference`` of DTensors, run on each rank's shards and
    returned as DTensors in x's shard placements (module docstring). A
    replicated operand of a computation cut over a mesh dim gets a partial
    gradient there: A over the batch, B / C over the heads."""
    from torch.distributed.tensor import Partial

    mesh = x.device_mesh
    px = rule_placements(x.shape, mesh, {0: "batch", 2: "ssm_inner"})
    batch, heads = _roles(px, 2)
    ph = _operand_placements(batch, heads, 1, True)
    pa = _operand_placements(batch, heads, 0, False)
    pbc = _operand_placements(batch, heads, None, True)
    ga = [Partial() if b else p for b, p in zip(batch, pa)]
    gbc = [Partial() if h else p for h, p in zip(heads, pbc)]
    y, final = ssd_reference(
        local_shard(x, mesh, px), local_shard(dt, mesh, px), local_shard(A, mesh, pa, ga),
        local_shard(Bv, mesh, pbc, gbc), local_shard(Cv, mesh, pbc, gbc), chunk,
        None if h0 is None else local_shard(h0, mesh, ph))
    return from_shards(y, mesh, px), from_shards(final, mesh, ph)


def ssm_forward(
    p: Params,
    xin: torch.Tensor,           # (B,L,D)
    cfg: ModelConfig,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 block. Returns (out (B,L,D), final_state
    (B,H,P,N), conv_state (B,K,cdim)) — the latter two seed the decode
    caches after prefill. With the kernels, the SSD's intra-chunk work is
    K6."""
    b, l, _ = xin.shape
    di, nh, g, n = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_state
    hd = di // nh

    zxbcdt = xin @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim(cfg), nh], dim=-1)
    # conv state = the last K raw (pre-conv) xbc rows, left-padded if l < K
    k = cfg.ssm_conv
    conv_state = F.pad(xbc, (0, 0, max(0, k - l), 0))[:, -k:, :]
    xbc = _causal_conv_full(xbc, p["conv_w"], p["conv_b"])
    x, Bv, Cv = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = x.reshape(b, l, nh, hd)
    Bv = Bv.reshape(b, l, g, n)
    Cv = Cv.reshape(b, l, g, n)
    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cfg.attn_impl != "reference":
        from ..kernels.ssd import ops as ssd_ops

        y, final = ssd_ops.ssd(x, dt, A, Bv, Cv, cfg.ssm_chunk, h0)
    else:
        y, final = ssd_reference(x, dt, A, Bv, Cv, cfg.ssm_chunk, h0)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * x
    y = y.reshape(b, l, di)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ p["out_proj"], final, conv_state.to(xin.dtype)


# ---------------------------------------------------------------------------
# Decode: the O(1) recurrent step
# ---------------------------------------------------------------------------

def init_ssm_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    di, nh, n = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_state
    return {
        "h": torch.zeros((batch, nh, di // nh, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv, conv_dim(cfg)), dtype=dtype, device=device),
    }


def _recurrence(h, x, dt, A, Bv, Cv, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token's state update and readout in f32: h (B,H,P,N), x
    (B,H,P), dt (B,H), A and D (H,), B / C (B,N); returns (y (B,H,P),
    h_new). DTensors run on their shards (``_recurrence_on_shards``)."""
    if is_dtensor(h):
        return _recurrence_on_shards(h, x, dt, A, Bv, Cv, D)
    f32 = torch.float32
    decay = torch.exp(dt * A)                                       # (B,H)
    h_new = (
        h.to(f32) * decay[:, :, None, None]
        + dt[:, :, None, None] * x.to(f32)[:, :, :, None] * Bv.to(f32)[:, None, None, :]
    )
    y = torch.einsum("bhpn,bn->bhp", h_new, Cv.to(f32))
    return y + D[None, :, None] * x.to(f32), h_new


def _recurrence_on_shards(h, x, dt, A, Bv, Cv, D):
    """``_recurrence`` of DTensors on each rank's shards, returned as
    DTensors in h's shard placements (module docstring)."""
    mesh = h.device_mesh
    ph = rule_placements(h.shape, mesh, {0: "batch", 1: "ssm_inner"})
    batch, heads = _roles(ph, 1)
    pa = _operand_placements(batch, heads, 0, False)
    pbc = _operand_placements(batch, heads, None, True)
    y, h_new = _recurrence(
        local_shard(h, mesh, ph), local_shard(x, mesh, ph), local_shard(dt, mesh, ph),
        local_shard(A, mesh, pa), local_shard(Bv, mesh, pbc), local_shard(Cv, mesh, pbc),
        local_shard(D, mesh, pa))
    return from_shards(y, mesh, ph), from_shards(h_new, mesh, ph)


def ssm_decode_step(
    p: Params,
    xin: torch.Tensor,            # (B,1,D)
    state: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through a Mamba2 mixer: returns (out (B,1,D), new state).
    Plain tensor ops, as in JAX (no kernel); the new state is returned, not
    written into ``state``."""
    b = xin.shape[0]
    di, nh, g, n = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_state
    hd = di // nh

    zxbcdt = xin[:, 0] @ p["in_proj"]                               # (B, ·)
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim(cfg), nh], dim=-1)

    conv = torch.cat([state["conv"][:, 1:], xbc[:, None, :]], dim=1)
    xbc = F.silu(torch.sum(conv * p["conv_w"][None], dim=1) + p["conv_b"])
    x, Bv, Cv = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = x.reshape(b, nh, hd)
    Bv = Bv.reshape(b, g, n)[:, 0]                                  # (B,N)
    Cv = Cv.reshape(b, g, n)[:, 0]
    dt = softplus(dt.float() + p["dt_bias"])                        # (B,H)
    A = -torch.exp(p["A_log"])

    y, h_new = _recurrence(state["h"], x, dt, A, Bv, Cv, p["D"])
    y = flatten(y, 1, 2).to(xin.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"h": h_new.to(state["h"].dtype), "conv": conv}
