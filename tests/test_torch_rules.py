"""Rules the port must keep, so a later slice cannot break them quietly:

- import isolation: with ``jax`` and the ``repro`` package blocked from
  being imported, every module of ``repro_torch`` and ``chip_smoke.py``
  still imports;
- the device rule: entry points default to the GPU and raise without one
  (no quiet fall back to the CPU); kernel wrappers dispatch on the tensor's
  device alone."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

_ISOLATED = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "repro")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.path[:0] = [SRC, ROOT]
    import repro_torch
    names = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]
    for must in ("repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.decode_attention.ops",
                 "repro_torch.core.manager", "repro_torch.store.kv_ship",
                 "repro_torch.edge.cluster", "repro_torch.launch.serve",
                 "repro_torch.fleet.workload", "repro_torch.models.moe",
                 "repro_torch.configs.granite_moe_3b_a800m",
                 "repro_torch.configs.chatglm3_6b", "repro_torch.configs.qwen2_vl_7b",
                 "repro_torch.configs.gemma2_27b", "repro_torch.configs.musicgen_medium",
                 "repro_torch.configs.nemotron_4_340b"):
        assert must in names, must
    for n in names:
        importlib.import_module(n)
    importlib.import_module("chip_smoke")
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_no_jax_and_nothing_of_repro():
    code = f"SRC, ROOT = {os.path.join(ROOT, 'src')!r}, {ROOT!r}\n" + _ISOLATED
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module was walked: the kernels, the serving stack, the
    # DisCEdge system layers (core, store, edge, data, launch), the fleet
    # layer, the MoE layer and the configs of qwen2, granite, dbrx,
    # chatglm3, qwen2-vl and gemma2
    assert int(out.stdout.strip().splitlines()[-1]) >= 78


def test_entry_points_default_to_cuda_and_raise_without_it():
    """On a machine without a GPU, every entry point called without a
    device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import (
        CHATGLM3_6B,
        GEMMA2_27B,
        GRANITE_MOE_3B_A800M,
        PAPER_QWEN15_0_5B,
        QWEN2_VL_7B,
    )
    from repro_torch.launch import serve
    from repro_torch.models import init_params, params_from_numpy
    from repro_torch.serving import BatchedLLMService, InferenceEngine, TorchLLMService

    cfg = PAPER_QWEN15_0_5B.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", PAPER_QWEN15_0_5B.name, "--turns", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", GRANITE_MOE_3B_A800M.name, "--turns", "1"])
    for arch in (CHATGLM3_6B, QWEN2_VL_7B, GEMMA2_27B):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch.name, "--turns", "1"])
        small = arch.reduced()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(small)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine.create(small)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchLLMService.create("m", small, page_size=16, kv_pages=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedLLMService.create("m", small, paged=True, kv_pages=8)
    moe = GRANITE_MOE_3B_A800M.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(moe)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLLMService.create("m", moe, kv_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedLLMService.create("m", moe, paged=True, kv_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine.create(cfg, kv_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLLMService.create("m", cfg, kv_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedLLMService.create("m", cfg, paged=True, kv_pages=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLLMService.create("m", cfg, kv_reuse=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"embed": {}, "groups": ()}, cfg)
    # explicit CPU works
    eng = InferenceEngine.create(cfg, kv_pages=8, max_len=64, device="cpu")
    assert eng.device.type == "cpu"
    assert next(iter(eng.params["embed"].values())).device.type == "cpu"
    svc = BatchedLLMService.create("m", cfg, paged=True, kv_pages=8, max_len=64, device="cpu")
    assert svc.server.device.type == "cpu"


def test_full_width_batched_server_is_ported_and_keeps_the_device_rule():
    """The full-width batched server (paged=False) is ported and is the
    default of BatchedLLMService, as in JAX: without a device it runs on
    the card, so it raises here (no GPU); with device="cpu" it serves."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.serving import BatchedLLMService

    cfg = PAPER_QWEN15_0_5B.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedLLMService.create("m", cfg)
    svc = BatchedLLMService.create("m", cfg, max_len=64, device="cpu")
    assert not svc.server.paged and svc.server.allocator is None
    assert svc.server.caches[0]["k"].device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors and launches
    its kernel only for CUDA tensors; any other device raises."""
    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention, shared_prefix

    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_attention(torch.empty(1, 1, 4, 16, **meta), torch.empty(2, 8, 2, 16, **meta),
                        torch.empty(2, 8, 2, 16, **meta), torch.empty(1, 1, **i32),
                        torch.empty(1, 1, **i32), torch.empty(1, 8, **i32))
    with pytest.raises(ValueError, match="unsupported device"):
        shared_prefix(torch.empty(1, 2, 2, 16, **meta), torch.empty(2, 8, 2, 16, **meta),
                      torch.empty(2, 8, 2, 16, **meta), torch.empty(1, **i32),
                      torch.empty(1, **i32))
    with pytest.raises(ValueError, match="unsupported device"):
        chunked_prefill_attention(torch.empty(1, 8, 4, 16, **meta),
                                  torch.empty(2, 8, 2, 16, **meta),
                                  torch.empty(2, 8, 2, 16, **meta), torch.empty(1, 1, **i32),
                                  torch.empty(1, **i32), torch.empty(1, **i32))
    kv = [torch.empty(1, 8, 2, 16, **meta) for _ in range(2)]
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(torch.empty(1, 4, 4, 16, **meta), *kv, torch.empty(1, 4, **i32),
                        torch.empty(1, 8, **i32), torch.empty(1, 8, **i32))
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(torch.empty(1, 1, 4, 16, **meta), *kv, torch.empty(1, 1, **i32),
                         torch.empty(1, 8, **i32), torch.empty(1, 8, **i32))
