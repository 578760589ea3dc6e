"""The port's launch layer (``repro_torch.launch.{perfmodel, roofline,
dryrun, report}``) against the reference's ``repro.launch``.

* ``perfmodel``: every closed form on every cell's config and shape, at
  256 and 512 ranks, equal to the reference's as Python floats.
* ``roofline.analyze``: the reference's ``analyze`` on a stub compiled
  executable (an HLO text whose collectives carry bf16 payloads, so its
  bf16-wire count is its plain one) with its rates set to the H100's,
  against the port's on the same figures and the same collective bytes
  counted the port's way: every term equal.
* ``dryrun.run_cell`` in one subprocess on a fake group of 256 ranks, on
  one LM, one GNN and one RecSys cell: the record's keys are the
  reference's less the XLA-only ones (``compile_s``, ``temp_size_in_bytes``,
  ``alias_size_in_bytes``), the note says so, the argument bytes are
  ``bytes_per_rank`` of the spec, and the collective bytes are there.
* ``report``'s three tables on one hand-written records file, character
  for character against the reference's (the MFU column with the
  reference's peak put in; the memory table's header names the H100's
  80 GB where the reference's names a 16 GB TPU).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LMS = ["gemma-2b", "phi3-mini-3.8b", "qwen3-4b", "deepseek-v3-671b", "mixtral-8x7b"]
GNNS = ["egnn", "gat-cora", "mace", "gin-tu"]


@pytest.mark.parametrize("name", LMS)
def test_lm_perfmodel_equals_the_reference(name):
    import repro.configs as jc
    from repro.launch import perfmodel as jpm

    import repro_torch.configs as tc
    from repro_torch.launch import perfmodel as tpm

    cfg, jcfg = tc.get_arch(name).config, jc.get_arch(name).config
    for shape, info in tc.lm_family.LM_SHAPES.items():
        b, s = info["batch"], info["seq"]
        for fn in ("lm_attention_flops", "lm_train_flops", "lm_prefill_flops",
                   "lm_decode_flops"):
            assert getattr(tpm, fn)(cfg, b, s) == getattr(jpm, fn)(jcfg, b, s), fn
        assert tpm.lm_attention_flops(cfg, b, s, causal_avg=False) == \
            jpm.lm_attention_flops(jcfg, b, s, causal_avg=False)
        for chips in (256, 512):
            for md in ("float32", "bfloat16"):
                for nmb in (1, 2, 8):
                    assert tpm.lm_train_bytes_per_device(
                        cfg, b, s, chips, moment_dtype=md, microbatches=nmb
                    ) == jpm.lm_train_bytes_per_device(
                        jcfg, b, s, chips, moment_dtype=md, microbatches=nmb)
            assert tpm.lm_decode_bytes_per_device(cfg, b, s, chips) == \
                jpm.lm_decode_bytes_per_device(jcfg, b, s, chips)
            assert tpm.lm_prefill_bytes_per_device(cfg, b, s, chips) == \
                jpm.lm_prefill_bytes_per_device(jcfg, b, s, chips)


@pytest.mark.parametrize("name", GNNS)
def test_gnn_perfmodel_equals_the_reference(name):
    import repro.configs as jc
    from repro.launch import perfmodel as jpm

    import repro_torch.configs as tc
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.launch import perfmodel as tpm

    arch, jarch = tc.get_arch(name), jc.get_arch(name)
    for shape, info in GNN_SHAPES.items():
        cfg, jcfg = arch.config_for(shape), jarch.config_for(shape)
        n, m, d = info["n"], info["m"], info["d"]
        assert tpm.gnn_train_flops(name, cfg, n, m, d) == jpm.gnn_train_flops(
            name, jcfg, n, m, d)
        for chips in (256, 512):
            assert tpm.gnn_train_bytes_per_device(name, cfg, n, m, d, chips) == \
                jpm.gnn_train_bytes_per_device(name, jcfg, n, m, d, chips)
    with pytest.raises(ValueError):
        tpm.gnn_train_flops("gcn", arch.config, 1, 1, 1)


def test_recsys_perfmodel_equals_the_reference():
    import repro.configs as jc
    from repro.launch import perfmodel as jpm

    import repro_torch.configs as tc
    from repro_torch.configs.recsys_family import RECSYS_SHAPES
    from repro_torch.launch import perfmodel as tpm

    cfg, jcfg = tc.get_arch("xdeepfm").config, jc.get_arch("xdeepfm").config
    for info in RECSYS_SHAPES.values():
        for train in (True, False):
            assert tpm.recsys_step_flops(cfg, info["batch"], train=train) == \
                jpm.recsys_step_flops(jcfg, info["batch"], train=train)
            for chips in (256, 512):
                assert tpm.recsys_bytes_per_device(
                    cfg, info["batch"], chips, train=train
                ) == jpm.recsys_bytes_per_device(jcfg, info["batch"], chips, train=train)


_HLO = """HloModule step

ENTRY %main (p: bf16[4096,1024]) -> bf16[4096,1024] {
  %ar = bf16[4096,1024]{1,0} all-reduce(bf16[4096,1024]{1,0} %p), replica_groups={}
  %ag = bf16[65536,1024]{1,0} all-gather(bf16[4096,1024]{1,0} %ar), dimensions={0}
  %rs = bf16[256,1024]{1,0} reduce-scatter(bf16[4096,1024]{1,0} %ar), dimensions={0}
  %a2a = bf16[4096,1024]{1,0} all-to-all(bf16[4096,1024]{1,0} %ar), dimensions={0}
  ROOT %out = bf16[4096,1024]{1,0} add(%a2a, %a2a)
}
"""


@pytest.mark.parametrize("figures", [
    dict(model_flops_total=2.8e16, flops_total=3.2e16, hbm_bytes_per_device=1.4e10),
    dict(model_flops_total=4.0e12, flops_total=None, hbm_bytes_per_device=7.0e11),
    dict(model_flops_total=1.0e9, flops_total=1.0e9, hbm_bytes_per_device=1.0e3),
])
def test_analyze_gives_the_references_terms_at_the_h100_rates(monkeypatch, figures):
    from repro.launch import roofline as jrl
    from repro_torch.configs.common import DryRunSpec
    from repro_torch.distributed.collectives import Traffic
    from repro_torch.launch import roofline as trl

    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    monkeypatch.setattr(jrl, "PEAK_FLOPS", trl.PEAK_FLOPS)
    monkeypatch.setattr(jrl, "HBM_BW", trl.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", trl.NVLINK_BW)
    compiled = SimpleNamespace(
        cost_analysis=lambda: {"flops": 1.0, "bytes accessed": 2.0},
        as_text=lambda: _HLO,
        memory_analysis=lambda: SimpleNamespace(argument_size_in_bytes=10,
                                                output_size_in_bytes=20))
    want = jrl.analyze(compiled, 256, **figures).as_dict()
    traffic = Traffic()
    for op, shape in (("all-reduce", (4096, 1024)), ("all-gather", (65536, 1024)),
                      ("reduce-scatter", (256, 1024)), ("all-to-all", (4096, 1024))):
        traffic.add(op, torch.empty(shape, dtype=torch.bfloat16, device="meta"))
    spec = DryRunSpec(fn=None, args=(), in_specs=(), **figures)
    got = trl.analyze(spec, 256, traffic, memory_per_device={
        "argument_size_in_bytes": 10, "output_size_in_bytes": 20}).as_dict()
    assert got.keys() == want.keys()
    for key in got:
        if key != "raw_cost_analysis":
            assert got[key] == want[key], key
    assert got["raw_cost_analysis"] == {}


_CELLS = [("gemma-2b", "decode_32k"), ("gin-tu", "full_graph_sm"),
          ("xdeepfm", "serve_p99")]

_RUN = """
import json, sys
from repro_torch.launch import dryrun
dryrun.start_fake_group(256)
from types import SimpleNamespace
from repro_torch.configs import get_arch
from repro_torch.configs.common import bytes_per_rank
out = []
for arch, shape in {cells!r}:
    rec = dryrun.run_cell(arch, shape, False, verbose=False)
    mesh = SimpleNamespace(axis_names=("data", "model"), shape={{"data": 16, "model": 16}})
    spec = get_arch(arch).build(shape, mesh)
    rec["want_args"] = sum(bytes_per_rank(a, s, mesh)
                           for a, s in zip(spec.args, spec.in_specs))
    out.append(rec)
out.append(dryrun.run_cell("qwen3-4b", "long_500k", False))
print(json.dumps(out))
"""


def test_run_cell_records_match_the_references_keys():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _RUN.format(cells=_CELLS)],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(proc.stdout.splitlines()[-1])
    want_keys = {"arch", "shape", "mesh", "status", "chips", "lower_s",
                 "compile_s", "note", "roofline"} - {"compile_s"}
    roof_keys = {"flops_total", "hbm_bytes_per_device", "collective_bytes_per_device",
                 "collective_bytes_bf16_wire", "compute_s", "memory_s",
                 "collective_s", "collective_s_bf16_wire", "bottleneck",
                 "model_flops_total", "useful_flops_fraction", "roofline_fraction",
                 "collectives", "memory_per_device", "raw_cost_analysis"}
    for (arch, shape), rec in zip(_CELLS, recs):
        want_args = rec.pop("want_args")
        assert rec["status"] == "ok", rec
        assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
            arch, shape, "single", 256)
        assert set(rec) == want_keys
        assert set(rec["roofline"]) == roof_keys
        mem = rec["roofline"]["memory_per_device"]
        assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes"}
        assert mem["argument_size_in_bytes"] == want_args
        assert "temp_size_in_bytes" in rec["note"] and "compile_s" in rec["note"]
        assert set(rec["roofline"]["collectives"]) == {"bytes_by_op", "count_by_op"}
        assert rec["roofline"]["collective_bytes_per_device"] > 0
    assert recs[-1] == {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "single",
                        "status": "skip", "reason": recs[-1]["reason"]}


RECORDS = [
    {"arch": "qwen3-4b", "shape": "train_4k", "mesh": "single", "status": "ok",
     "chips": 256, "roofline": {
         "compute_s": 0.125, "memory_s": 0.0043, "collective_s": 0.61,
         "collective_s_bf16_wire": 0.305, "bottleneck": "collective",
         "model_flops_total": 2.775e16, "useful_flops_fraction": 0.8796,
         "memory_per_device": {"argument_size_in_bytes": 690268932,
                               "temp_size_in_bytes": 2_000_000_000}}},
    {"arch": "qwen3-4b", "shape": "long_500k", "mesh": "single", "status": "skip",
     "reason": "full quadratic attention; 500k-token decode excluded per "
               "assignment (run only for SSM/hybrid/sliding-window archs)"},
    {"arch": "gin-tu", "shape": "molecule", "mesh": "single", "status": "ok",
     "chips": 256, "roofline": {
         "compute_s": 2.5e-7, "memory_s": 4.5e-5, "collective_s": 1.2e-6,
         "bottleneck": "memory", "model_flops_total": 6.3e10,
         "useful_flops_fraction": 1.0,
         "memory_per_device": {"argument_size_in_bytes": 96_000_000_000}}},
    {"arch": "mace", "shape": "ogb_products", "mesh": "single", "status": "error",
     "error": "Traceback"},
    {"arch": "xdeepfm", "shape": "serve_p99", "mesh": "multi", "status": "ok",
     "chips": 512, "roofline": {
         "compute_s": 7e-8, "memory_s": 6.2e-6, "collective_s": 3.0,
         "bottleneck": "collective", "model_flops_total": 3.5e10,
         "useful_flops_fraction": 1.0, "memory_per_device": {}}},
]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_report_tables_match_the_references(tmp_path, monkeypatch, mesh):
    from repro.launch import report as jr
    from repro_torch.launch import report as tr
    from repro_torch.launch import roofline as trl

    base, opt = tmp_path / "base.json", tmp_path / "opt.json"
    base.write_text(json.dumps(RECORDS))
    faster = json.loads(json.dumps(RECORDS))
    faster[0]["roofline"]["collective_s"] = 0.2
    opt.write_text(json.dumps(faster))
    # The reference's table divides by its chip's peak; the port's by the
    # H100's. With the reference's peak put in they must agree exactly.
    h100 = tr.roofline_markdown(str(base), mesh)
    monkeypatch.setattr(trl, "PEAK_FLOPS", 197e12)
    assert tr.roofline_markdown(str(base), mesh) == jr.roofline_markdown(str(base), mesh)
    if mesh == "single":
        assert h100 != jr.roofline_markdown(str(base), mesh)
    got = tr.memory_markdown(str(base), mesh)
    want = jr.memory_markdown(str(base), mesh)
    assert got == want.replace("fits 16GB v5e", "fits 80GB H100")
    cells = [(r["arch"], r["shape"], r["mesh"]) for r in RECORDS]
    assert tr.compare_markdown(str(base), str(opt), cells) == jr.compare_markdown(
        str(base), str(opt), cells)
