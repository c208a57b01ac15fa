"""Rules the port must keep, so a later slice cannot break them quietly:

- import isolation: with ``jax``, the ``repro`` package and ``msgpack``
  (absent from the card's machine; the checkpoint carries its own codec)
  blocked from being imported, every module of ``repro_torch`` and
  ``chip_smoke.py`` still imports;
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

    BLOCKED = ("jax", "jaxlib", "repro", "msgpack")

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
                 "repro_torch.configs.nemotron_4_340b", "repro_torch.kernels.guard",
                 "repro_torch.training.optimizer", "repro_torch.training.trainer",
                 "repro_torch.training.checkpoint", "repro_torch.training._msgpack",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.launch.shapes", "repro_torch.launch.sharding",
                 "repro_torch.launch.dryrun", "repro_torch.models.pjit_rules",
                 "repro_torch.core.mesh_context", "repro_torch.roofline",
                 "repro_torch.roofline.analysis", "repro_torch.models.attention",
                 "repro_torch.models.transformer"):
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
    # chatglm3, qwen2-vl and gemma2, the training modules and launcher,
    # and the launch's specs and analysis (mesh, shapes, sharding, dryrun,
    # pjit_rules, mesh_context, roofline and its analysis)
    assert int(out.stdout.strip().splitlines()[-1]) >= 93


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
    from repro_torch.launch import serve, train
    from repro_torch.models import init_params, params_from_numpy
    from repro_torch.serving import BatchedLLMService, InferenceEngine, TorchLLMService

    cfg = PAPER_QWEN15_0_5B.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", PAPER_QWEN15_0_5B.name, "--turns", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", GRANITE_MOE_3B_A800M.name, "--turns", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", PAPER_QWEN15_0_5B.name, "--steps", "1"])
    # the mesh and the dry-run default to the card too, before any group
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", PAPER_QWEN15_0_5B.name, "--shape", "train_4k"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", PAPER_QWEN15_0_5B.name, "--dry-run"])
    import torch.distributed as dist

    assert not dist.is_initialized()
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


def test_train_step_runs_where_its_tensors_are():
    """``make_train_step`` has no device of its own: on CPU params and a CPU
    batch it trains on the CPU and leaves every tensor there."""
    from repro_torch.configs import PAPER_QWEN15_0_5B
    from repro_torch.data import BatchIterator
    from repro_torch.models import init_params
    from repro_torch.training import OptConfig, init_opt_state, make_train_step
    from repro_torch.models.weights import tree_leaves

    cfg = PAPER_QWEN15_0_5B.reduced(n_layers=1)
    params = init_params(cfg, device="cpu")
    opt = init_opt_state(params)
    batch = {k: torch.from_numpy(v) for k, v in next(BatchIterator(cfg, 1, 16)).items()}
    params, opt, m = make_train_step(cfg, OptConfig())(params, opt, batch)
    assert {t.device.type for t in tree_leaves([params, opt, m])} == {"cpu"}


def test_kernel_wrappers_stay_differentiable_on_cpu_tensors():
    """The guard that stops a kernel launch under autograd is for the card
    only: on CPU tensors that require grad a wrapper runs its plain version,
    whose output autograd tracks back to every input."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=gen).requires_grad_() for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32)[None]
    before = flash_attention.launches
    out = flash_attention(q, k[:, :, :2], v[:, :, :2], pos, pos, torch.ones(1, 8, dtype=torch.bool))
    out.sum().backward()
    assert flash_attention.launches == before
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))
    x = torch.randn(1, 32, 2, 8, generator=gen).requires_grad_()
    dt = torch.rand(1, 32, 2, generator=gen)
    bc = torch.randn(1, 32, 1, 4, generator=gen)
    y, _ = ssd(x, dt, -torch.ones(2), bc, bc, 16)
    y.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
