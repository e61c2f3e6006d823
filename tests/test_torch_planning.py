"""The planning tools (`repro_torch.launch.{roofline,dryrun,perf}`) against
the reference's, on the CPU.

* The HLO functions are the reference's, copied: on the HLO text of the
  reference's reduced llama3.2-3b train cell (seq 128, batch 8, on a
  (data 4, model 2) mesh of 8 forced host devices, as the reference's
  `tests/integration/test_end_to_end.py` builds it) and on a crafted module
  (explicit, iota and transposed-iota groups, a while loop with a trip
  count, a call edge, every collective kind), at several pod strides.
* `analyze_cell` for every registry config x every LM_SHAPES shape x both
  meshes: with the port's constants set to the reference's (in the test
  only), every key equals the reference's; with the H100's, the compute
  and memory terms are the same FLOPs and bytes over the H100's rates.
* `build_cell` on the same 4 x 2 cells (llama, mixtral's experts axis,
  xlstm's recurrent stack): the per-device argument and output bytes equal
  the reference's `memory_analysis` exactly, and the accumulation count its.
* The collectives table derived from the sharding rules, beside the
  reference's HLO table for the llama cell: the kinds equal, the link
  classes equal at every pod stride, the bytes a link class within
  RULES_FACTOR.
* Prefill and decode cells fail as the reference's do (C13), and so do the
  two decode variants of perf.py; the mixtral variants' terms are the
  reference's analytic model over the H100's constants.
* The dry-run and roofline CLIs write records with the reference's keys,
  only where they are told to.
"""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import registry as r_registry
from repro.launch import roofline as r_rl
from repro.models import flops as r_flops
from repro_torch.configs import registry
from repro_torch.launch import dryrun, perf, roofline
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import LM_SHAPES
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_ARCHS = ("llama3.2-3b", "mixtral-8x7b", "xlstm-350m")
SHAPES = [c.name for c in LM_SHAPES]
CELL = dataclasses.replace({c.name: c for c in LM_SHAPES}["train_4k"], seq_len=128,
                           global_batch=8)
MESH = Mesh(("data", "model"), (4, 2))
# the derived table against the reference's HLO table for the llama cell:
# the HLO's bytes are 8.0x the rules' (10,521,684 vs 1,315,584). XLA's CPU
# backend computes the bf16 activations in float32 (2x), and at this width
# its partitioner gathers the batch of activations over the data axis (four
# all-gathers of the [8, 128, 256] FFN activations, 1 MiB each) instead of
# the FSDP weights that the rules gather. Logged in ROADMAP §C (C14).
RULES_FACTOR = 10.0

_REF_CODE = """
import json, os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.launch.dryrun import build_cell, parse_collectives
from repro.configs import registry
from repro.models.config import LM_SHAPES
out_dir = sys.argv[1]
mesh = jax.make_mesh((4, 2), ("data", "model"))
cell = dataclasses.replace([c for c in LM_SHAPES if c.name == "train_4k"][0], seq_len=128,
                           global_batch=8)
res = {}
for arch in sys.argv[2:]:
    fn, args, in_sh, out_sh, extra = build_cell(registry.reduced(arch), cell, mesh)
    with mesh:
        c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
    mem = c.memory_analysis()
    hlo = c.as_text()
    path = os.path.join(out_dir, arch + ".hlo.txt")
    with open(path, "w") as f:
        f.write(hlo)
    res[arch] = dict(accum=extra["accum"], arg=int(mem.argument_size_in_bytes),
                     out=int(mem.output_size_in_bytes), parse=parse_collectives(hlo), hlo=path)
print("REF " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    """The reference's dry-run numbers for REF_ARCHS' reduced train cells on
    a 4 x 2 mesh of 8 forced host devices, compiled in a subprocess (the
    reference's own slow test's setup): {arch: {accum, arg, out, parse,
    hlo (its text)}}."""
    tmp = tmp_path_factory.mktemp("ref_hlo")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp)}
    out = subprocess.run([sys.executable, "-c", _REF_CODE, str(tmp), *REF_ARCHS],
                         capture_output=True, text=True, env=env, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("REF ")]
    assert out.returncode == 0 and lines, out.stderr[-3000:]
    res = json.loads(lines[-1][4:])
    for rec in res.values():
        rec["hlo"] = pathlib.Path(rec["hlo"]).read_text()
    return res


# ---------------------------------------------------------------------------
# the HLO functions
# ---------------------------------------------------------------------------

CRAFTED = """HloModule crafted

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%cond.2 (p.2: s32[]) -> pred[] {
  %i = s32[] parameter(0)
  %c = s32[] constant(12)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%inner.4 (p.4: f32[64]) -> f32[64] {
  %q = f32[64]{0} parameter(0)
  ROOT %ar.in = f32[64]{0} all-reduce(%q), channel_id=7, replica_groups=[2,4]<=[8], use_global_device_ids=true, to_apply=%add
}

%body.1 (p.1: s32[]) -> s32[] {
  %x = f32[1024]{0} parameter(0)
  %ar = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups={{0,4},{1,5},{2,6},{3,7}}, use_global_device_ids=true, to_apply=%add
  %ag = bf16[8,64]{1,0} all-gather(%y), channel_id=2, replica_groups=[2,4]<=[4,2]T(1,0), dimensions={0}, use_global_device_ids=true
  %cl = f32[64]{0} call(%q), to_apply=%inner.4
  ROOT %r = s32[] add(%i, %one)
}

ENTRY %main.9 (a: f32[1024]) -> f32[1024] {
  %w = s32[] while(%t), condition=%cond.2, body=%body.1
  %rs = f32[256]{0} reduce-scatter(%a), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %a2a = (f32[64]{0}, f32[64]{0}) all-to-all(%a, %b), channel_id=4, replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = f32[16]{0} collective-permute(%z), channel_id=5, source_target_pairs={{0,1}}
  %ars = f32[32]{0} all-reduce-start(%q), channel_id=6, replica_groups=[4,2]<=[8], to_apply=%add
  %agt = s8[2,3,4]{2,1,0} all-gather(%u), channel_id=8, replica_groups=[4,2]<=[2,4]T(1,0), dimensions={0}
}
"""
POD_STRIDES = (1, 2, 4, 8, 256)


@pytest.mark.parametrize("pod_stride", POD_STRIDES)
def test_loop_aware_collectives_on_a_crafted_module(pod_stride):
    got = roofline.loop_aware_collectives(CRAFTED, pod_stride)
    assert got == r_rl.loop_aware_collectives(CRAFTED, pod_stride)
    # the while body's collectives x 12 trips, the call edge's too
    assert got["all-gather/count"] == 12 + 1 and got["all-reduce/count"] == 12 + 12 + 1
    assert set(k.split("/")[0] for k in got) == set(roofline._TRAFFIC_FACTOR)


@pytest.mark.parametrize("pod_stride", (4, 8, 256))
def test_loop_aware_collectives_on_the_reference_hlo(ref_cells, pod_stride):
    hlo = ref_cells["llama3.2-3b"]["hlo"]
    assert roofline.split_computations(hlo) == r_rl.split_computations(hlo)
    got = roofline.loop_aware_collectives(hlo, pod_stride)
    assert got == r_rl.loop_aware_collectives(hlo, pod_stride)
    for line in hlo.splitlines():
        if roofline._COLL_RE.search(line):
            assert (roofline._classify_link(line, pod_stride)
                    == r_rl._classify_link(line, pod_stride))


def test_shape_bytes_and_collective_seconds(monkeypatch):
    for t in ("f32[8,128,256]{2,1,0}", "(f32[], bf16[3,4], s8[7], pred[2])", "token[]",
              "(f32[8,128,2,32]{3,2,1,0}, u64[5])"):
        assert roofline._shape_bytes(t) == r_rl._shape_bytes(t), t
    colls = roofline.loop_aware_collectives(CRAFTED, 4)
    monkeypatch.setattr(roofline, "NVLINK_BW", r_rl.ICI_BW)
    monkeypatch.setattr(roofline, "IB_BW", r_rl.DCN_BW)
    assert roofline.collective_seconds(colls) == r_rl.collective_seconds(colls)


def test_the_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert (roofline.NVLINK_BW, roofline.IB_BW, roofline.GPUS_PER_NODE) == (450e9, 50e9, 8)
    ici, dcn = roofline.collective_seconds({"all-reduce/ici": 9e9, "all-gather/dcn": 5e9,
                                            "all-reduce/count": 3})
    assert (ici, dcn) == (2 * 9e9 / 450e9, 5e9 / 50e9)
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S is roofline.HBM_BW
    assert chip_smoke.BF16_TENSOR_OPS_PER_S is roofline.PEAK_FLOPS


# ---------------------------------------------------------------------------
# analyze_cell
# ---------------------------------------------------------------------------

TABLE = {"all-gather/ici": 4_194_304, "all-gather/count": 4, "all-reduce/ici": 5_250_084,
         "all-reduce/dcn": 1_077_296, "all-reduce/count": 25}


def _rec(arch, shape, mesh):
    return {"arch": arch, "shape": shape, "mesh": mesh, "kind": "train", "status": "ok",
            "collectives": dict(TABLE)}


@pytest.mark.parametrize("mesh", ("16x16", "2x16x16"))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", registry.names())
def test_analyze_cell_is_the_reference_s(arch, shape, mesh, monkeypatch):
    rec = _rec(arch, shape, mesh)
    h100 = roofline.analyze_cell(rec, None)
    chips = 512 if mesh == "2x16x16" else 256
    assert h100["chips"] == chips
    cell = {c.name: c for c in LM_SHAPES}[shape]
    ff = r_flops.cell_flops(r_registry.get(arch), cell)
    assert h100["analytic_flops"] == ff["total"]
    assert h100["t_compute_s"] == ff["total"] / (chips * 989e12)
    assert h100["t_memory_s"] == r_flops.cell_hbm_bytes(r_registry.get(arch), cell) / (
        chips * 3.35e12)
    for name, value in (("PEAK_FLOPS", r_rl.PEAK_FLOPS), ("HBM_BW", r_rl.HBM_BW),
                        ("NVLINK_BW", r_rl.ICI_BW), ("IB_BW", r_rl.DCN_BW)):
        monkeypatch.setattr(roofline, name, value)
    assert roofline.analyze_cell(rec, None) == r_rl.analyze_cell(_rec(arch, shape, mesh), None)


def test_analyze_cell_reads_an_hlo_dump(ref_cells, tmp_path, monkeypatch):
    tag = "llama3.2-3b__train_4k__16-16"
    (tmp_path / f"{tag}.hlo.txt").write_text(ref_cells["llama3.2-3b"]["hlo"])
    rec = _rec("llama3.2-3b", "train_4k", "16x16")
    for name, value in (("PEAK_FLOPS", r_rl.PEAK_FLOPS), ("HBM_BW", r_rl.HBM_BW),
                        ("NVLINK_BW", r_rl.ICI_BW), ("IB_BW", r_rl.DCN_BW)):
        monkeypatch.setattr(roofline, name, value)
    got = roofline.analyze_cell(rec, str(tmp_path))
    assert got == r_rl.analyze_cell(_rec("llama3.2-3b", "train_4k", "16x16"), str(tmp_path))
    assert got["collectives_loop_aware"]["all-reduce/count"] == 25


# ---------------------------------------------------------------------------
# build_cell: the per-device bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_build_cell_bytes_are_the_reference_memory_analysis(ref_cells, arch):
    ref = ref_cells[arch]
    fn, args, in_sh, out_sh, extra = dryrun.build_cell(registry.reduced(arch), CELL, MESH)
    assert extra == {"accum": ref["accum"]}
    assert dryrun.per_device_bytes(args, in_sh, MESH) == ref["arg"]
    outs, flops = dryrun.trace(fn, args)
    assert dryrun.output_bytes(outs, out_sh, MESH) == ref["out"]
    assert flops > 0 and all(x.device.type == "meta" for x, _ in dryrun._pairs(outs, out_sh))


@pytest.mark.parametrize("arch", registry.names())
def test_every_family_traces_on_meta_without_a_launch(arch):
    """Every reduced family's train step runs on `meta` (the kernel
    wrappers take their plain versions there) and launches nothing."""
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.mlstm import ops as m_ops
    from repro_torch.kernels.rglru import ops as r_ops

    counters = (f_ops.mha, f_ops.mha_backward, m_ops.mlstm, m_ops.mlstm_bwd, r_ops.rglru,
                r_ops.rglru_scan, r_ops.rglru_bwd)
    before = [fn.launches for fn in counters]
    fn, args, in_sh, out_sh, _ = dryrun.build_cell(registry.reduced(arch), CELL, MESH)
    outs, flops = dryrun.trace(fn, args)
    assert flops > 0 and [fn.launches for fn in counters] == before
    assert all(x.device.type == "meta" for x, _ in dryrun._pairs(outs, out_sh))
    assert dryrun.output_bytes(outs, out_sh, MESH) > dryrun.per_device_bytes(args[:2], in_sh[:2],
                                                                             MESH)


def test_the_llama_cell_s_bytes_are_the_ones_measured():
    """The numbers the reference printed for the llama cell (322,692 and
    320,952), held without the subprocess too."""
    fn, args, in_sh, out_sh, _ = dryrun.build_cell(registry.reduced("llama3.2-3b"), CELL, MESH)
    assert dryrun.per_device_bytes(args, in_sh, MESH) == 322_692
    assert dryrun.output_bytes(dryrun.trace(fn, args)[0], out_sh, MESH) == 320_952


def test_shard_bytes_and_group_span():
    x = torch.empty((16, 6, 5), dtype=torch.bfloat16, device="meta")
    mesh = Mesh(("pod", "data", "model"), (2, 4, 2))
    assert dryrun.shard_bytes(x, (("pod", "data"), "model", None), mesh) == 2 * 3 * 5 * 2
    assert dryrun.shard_bytes(x, (), mesh) == 16 * 6 * 5 * 2
    assert dryrun.shard_bytes(x, (None, None, "model"), mesh) == 16 * 6 * 3 * 2  # padded
    assert dryrun.group_span(mesh, ("model",)) == 2
    assert dryrun.group_span(mesh, ("data",)) == 7
    assert dryrun.group_span(mesh, ("pod", "data")) == 15
    assert dryrun.group_span(Mesh(("data", "model"), (16, 16)), ("data",)) == 241


# ---------------------------------------------------------------------------
# the collectives table from the rules, beside the reference's HLO table
# ---------------------------------------------------------------------------


def _by_link(table):
    out = {}
    for k, v in table.items():
        if not k.endswith("/count"):
            out[k.split("/")[1]] = out.get(k.split("/")[1], 0) + v
    return out


def test_rule_collectives_beside_the_reference_hlo(ref_cells):
    cfg = registry.reduced("llama3.2-3b")
    _, _, in_sh, _, extra = dryrun.build_cell(cfg, CELL, MESH)
    hlo = ref_cells["llama3.2-3b"]["hlo"]
    ref = ref_cells["llama3.2-3b"]["parse"]
    got = dryrun.rule_collectives(cfg, CELL, MESH, in_sh[0], extra["accum"])
    print(f"\nrules {got}\nreference HLO {ref}")
    kinds = {k.split("/")[0] for k in got}
    assert kinds == {k.split("/")[0] for k in ref} == {"all-gather", "all-reduce"}
    ratio = {link: ref_b / _by_link(got)[link] for link, ref_b in _by_link(ref).items()}
    assert set(ratio) == set(_by_link(got)) == {"ici"}
    assert all(1 / RULES_FACTOR <= r <= RULES_FACTOR for r in ratio.values()), ratio
    # the link classes by pod stride are the HLO's
    for stride in (4, 8, 256):
        mine = dryrun.rule_collectives(cfg, CELL, MESH, in_sh[0], extra["accum"],
                                       pod_stride=stride)
        theirs = r_rl.loop_aware_collectives(hlo, stride)
        assert set(mine) == set(theirs), stride


def test_rule_collectives_counts_layers_microbatches_and_recompute():
    cfg = registry.reduced("llama3.2-3b")
    cell = dataclasses.replace(CELL, global_batch=32)
    _, _, in_sh, _, _ = dryrun.build_cell(cfg, cell, MESH, accum=2)
    full = dryrun.rule_collectives(cfg, cell, MESH, in_sh[0], 2, remat="full")
    none = dryrun.rule_collectives(cfg, cell, MESH, in_sh[0], 2, remat=False)
    one = dryrun.rule_collectives(cfg, cell, MESH, in_sh[0], 1, remat=False)
    # the weights gather once a microbatch and forward pass (the recompute is
    # the layer groups' only: the embedding is gathered once a microbatch)
    assert none["all-gather/ici"] == 2 * one["all-gather/ici"]
    assert none["all-gather/ici"] < full["all-gather/ici"] < 2 * none["all-gather/ici"]
    assert full["all-reduce/count"] > none["all-reduce/count"] > one["all-reduce/count"]
    assert "reduce-scatter/count" not in full
    # one device: nothing to gather or reduce
    solo = Mesh(("data", "model"), (1, 1))
    _, _, sh1, _, _ = dryrun.build_cell(cfg, CELL, solo)
    assert dryrun.rule_collectives(cfg, CELL, solo, sh1[0], 1) == {}


# ---------------------------------------------------------------------------
# prefill / decode (C13), perf.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,status", [
    ("llama3.2-3b", "prefill_32k", "error"), ("llama3.2-3b", "decode_32k", "error"),
    ("llama3.2-3b", "long_500k", "skipped"), ("xlstm-350m", "long_500k", "error"),
])
def test_prefill_and_decode_cells_fail_as_the_reference_s(arch, shape, status):
    rec = dryrun.run_cell(arch, shape, multi_pod=False)
    assert rec["status"] == status
    if status == "error":
        assert set(rec) == {"arch", "shape", "mesh", "status", "error", "trace"}
        assert rec["error"] == ("AttributeError: module 'repro_torch.dist.sharding' has no "
                                "attribute 'cache_shardings'")
    else:
        assert rec["reason"] == "pure full-attention arch; long_500k skipped per DESIGN.md"


def _ref_hypothesis(fn_name: str) -> str:
    """A reference variant's docstring, read from its source (importing
    `repro.launch.perf` would set XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/perf.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return " ".join(ast.get_docstring(fn).split())


@pytest.mark.parametrize("variant", sorted(perf.VARIANTS))
def test_perf_variants(variant, tmp_path):
    # the reference's hypothesis word for word, then the note on its figures
    doc = " ".join(perf.VARIANTS[variant].__doc__.split())
    ref = _ref_hypothesis(perf.VARIANTS[variant].__name__)
    assert doc.startswith(ref) and "reckoned for the reference's TPU mesh" in doc[len(ref):]
    if variant in ("qwen2_int8_kv", "xlstm_tp_off"):
        with pytest.raises(AttributeError, match="cache_shardings"):
            perf.run_variant(variant, tmp_path / "log.json")
        assert not (tmp_path / "log.json").exists()
        return
    entry = perf.run_variant(variant, tmp_path / "log.json")
    assert json.loads((tmp_path / "log.json").read_text()) == [json.loads(json.dumps(entry))]
    cfg = r_registry.get("mixtral-8x7b")
    cell = {c.name: c for c in LM_SHAPES}["train_4k"]
    cases = {"mixtral_remat": ((cfg, "full"), (cfg, "dots")),
             "mixtral_capacity": ((cfg, "dots"),
                                  (dataclasses.replace(cfg, capacity_factor=1.0), "dots"))}
    for rec, (c, remat) in zip((entry["before"], entry["after"]), cases[variant]):
        assert rec["t_compute_s"] == r_flops.cell_flops(c, cell, remat=remat)["total"] / (
            256 * 989e12)
        assert rec["t_memory_s"] == r_flops.cell_hbm_bytes(c, cell) / (256 * 3.35e12)
        assert rec["temp_bytes"] is None and rec["accum"] == 8
        assert set(rec["collectives"]) == {"all-gather/dcn", "all-reduce/dcn"}
    assert entry["speedup_dominant"] > 1.0 and entry["hypothesis"] == doc


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _ref_run_cell_keys() -> set:
    """The keys the reference's `run_cell` writes on success, read from its
    source (importing it would set XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and all(isinstance(k, ast.Constant) for k in node.keys):
            keys |= {k.value for k in node.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "rec"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
        if isinstance(node, ast.Tuple) and all(
                isinstance(e, ast.Constant) and str(e.value).endswith("_in_bytes")
                for e in node.elts):
            keys |= {e.value for e in node.elts}
    return keys - {"reason"}  # the skipped record's


def test_dryrun_and_roofline_clis(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tmp_path / "dryrun.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-3b",
           "--shape", "train_4k", "--mesh", "single", "--out", str(d)]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[ok] llama3.2-3b train_4k 16x16 flops=" in out.stdout
    (rec,) = json.loads(d.read_text())
    # the reference's keys less what only a compiler gives ({"accum"} from build_cell)
    no_compiler = {"temp_size_in_bytes", "generated_code_size_in_bytes", "hlo_len"}
    assert set(rec) == (_ref_run_cell_keys() - no_compiler) | {"accum"}
    assert rec["status"] == "ok" and rec["bytes_accessed"] == -1.0 and rec["accum"] == 8
    cfg, cell = registry.get("llama3.2-3b"), LM_SHAPES[0]
    from repro_torch.models import flops

    analytic = flops.cell_flops(cfg, cell)["total"] / 256
    assert 0.8 < rec["flops"] / analytic < 1.2, (rec["flops"], analytic)
    # a second run resumes: the cell is done
    again = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                           timeout=600)
    assert "[skip-done] llama3.2-3b train_4k 16x16" in again.stdout
    r, md = tmp_path / "roofline.json", tmp_path / "roofline.md"
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dryrun",
                          str(d), "--out", str(r), "--markdown", str(md)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (row,) = json.loads(r.read_text())
    assert set(row) == set(r_rl.analyze_cell(dict(rec), None))
    assert md.read_text().count("| llama3.2-3b | train_4k | 16x16 |") == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dryrun.json", "roofline.json",
                                                         "roofline.md"]
