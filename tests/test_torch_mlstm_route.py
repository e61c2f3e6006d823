"""mLSTM on the serving path in bf16, the route to the tensor-core kernel of
`mlstm_chunk`: `mlstm_block` hands the wrapper its q, k, v heads in their
own dtype, and on the CPU its output and state equal the earlier route's
(float32 heads, h rounded by the block) bit for bit; the kernel's work and
bf16 bound at xlstm-350m's prefill shape."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.mlstm import ops as m_ops
from repro_torch.models import stack, xlstm
from repro_torch.models.schema import init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _mlstm_layer(dtype):
    """xlstm-350m reduced: the first mLSTM layer's weights (cast as the
    serving path casts them in bf16) and an input [2, 37, d_model]."""
    cfg = registry.reduced("xlstm-350m")
    params = init_params(stack.build_schema(cfg), torch.Generator().manual_seed(3), "cpu")
    if dtype == torch.bfloat16:
        params = stack.cast_weights(cfg, params)
    pfx, g, _, _ = next(layer for layer in stack._layers(cfg) if layer[2] == "mlstm")
    x = np.random.default_rng(5).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    return cfg, stack._layer(params, pfx, g), pfx + ".mix", torch.from_numpy(x).to(dtype)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mlstm_block_hands_the_wrapper_its_heads_dtype(dtype, monkeypatch):
    cfg, p, pfx, x = _mlstm_layer(dtype)
    real, seen = m_ops.mlstm, []

    def record(q, k, v, logi, logf):
        seen.append((q.dtype, k.dtype, v.dtype, logi.dtype, logf.dtype))
        return real(q, k, v, logi, logf)

    monkeypatch.setattr(m_ops, "mlstm", record)
    out, state = xlstm.mlstm_block(cfg, p, pfx, x, return_state=True)
    assert seen == [(dtype,) * 3 + (torch.float32,) * 2]
    assert out.dtype == dtype
    # the earlier route: float32 heads into the kernel's plain version, h
    # rounded to the block's dtype afterwards
    monkeypatch.setattr(xlstm, "mlstm_parallel",
                        lambda q, k, v, li, lf: real(q.float(), k.float(), v.float(), li, lf))
    old_out, old_state = xlstm.mlstm_block(cfg, p, pfx, x, return_state=True)
    assert torch.equal(out, old_out)
    old = dict(_leaves(old_state))
    for name, leaf in _leaves(state):
        assert leaf.dtype == old[name].dtype and torch.equal(leaf, old[name]), name


def test_mlstm_work_and_bf16_bound_at_the_serving_shape():
    """[8,4,2048,256] in bf16: 6.875e10 flops, ~134.7 MB, bounded by the
    tensor cores at 0.0695 ms (the bytes alone take 0.040 ms)."""
    shape = (8, 4, 2048, 256)
    nbytes, flops = chip_smoke.mlstm_work(shape, 2)
    assert flops == 4 * 256 * 8 * 4 * 2048 * 2049 // 2 == 68_753_031_168
    assert nbytes == 4 * 8 * 4 * 2048 * 256 * 2 + 2 * 8 * 4 * 2048 * 4 == 134_742_016
    ms, by = chip_smoke.bound(nbytes, flops, chip_smoke.BF16_TENSOR_OPS_PER_S)
    assert by == "operations" and ms == pytest.approx(0.0695, abs=5e-5)
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0402, abs=5e-5)
    # the float32 kernel's bound, kept beside it: the CUDA cores
    ms32, by32 = chip_smoke.bound(*chip_smoke.mlstm_work(shape, 4))
    assert by32 == "operations" and ms32 == pytest.approx(1.026, abs=5e-4)
