"""The port's config registry and dry-run specs (``repro_torch.configs``)
against the reference's.

* The registry, the forty cells and their skip reasons, each LM's
  ``LMArch`` fields, and the paper's configs field for field.
* ``zero_spec`` against the reference's on cases that reach each of its
  branches (both axes, the first alone, none).
* ``build`` of all 72 unskipped (arch, shape, mesh) cells on the
  production meshes (16, 16) and (2, 16, 16), under ``REPRO_OPT_LEVEL``
  0 and 1: ``model_flops_total``, ``flops_total``,
  ``hbm_bytes_per_device`` and ``note`` equal, and the bytes one rank
  holds of each argument group (params, step, m, v, batch, cache) equal
  to the reference's sum of ``NamedSharding.shard_shape`` bytes. The
  reference builds on ``AbstractMesh``es in one subprocess per level
  (it reads the level at import); the port builds on plain stubs of the
  mesh in this process with the level set by ``monkeypatch``, its
  per-rank bytes from ``configs/common.py::bytes_per_rank``. The port
  keeps one module per layer where the reference stacks them, so only
  the byte totals are compared, never the leaves.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

_REF_SCRIPT = r"""
import json, math, sys
import jax
from jax.sharding import AbstractMesh, NamedSharding
from repro.configs import ARCH_NAMES, get_arch

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

def nbytes(tree, shardings):
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
               for l, s in zip(leaves, shs))

out = {}
for mname, (shape, axes) in MESHES.items():
    mesh = AbstractMesh(shape, axes)
    for a in ARCH_NAMES:
        arch = get_arch(a)
        for s in arch.shapes():
            if arch.skip_reason(s):
                continue
            spec = arch.build(s, mesh)
            groups = {"params": nbytes(spec.args[0], spec.in_shardings[0])}
            if isinstance(spec.args[1], dict) and "step" in spec.args[1]:
                for k in ("step", "m", "v"):
                    groups[k] = nbytes(spec.args[1][k], spec.in_shardings[1][k])
                groups["batch"] = nbytes(spec.args[2], spec.in_shardings[2])
            elif len(spec.args) == 3:
                groups["cache"] = nbytes(spec.args[1], spec.in_shardings[1])
                groups["batch"] = nbytes(spec.args[2], spec.in_shardings[2])
            else:
                groups["batch"] = nbytes(spec.args[1], spec.in_shardings[1])
            out[f"{a}|{s}|{mname}"] = dict(
                model_flops_total=spec.model_flops_total,
                flops_total=spec.flops_total,
                hbm_bytes_per_device=spec.hbm_bytes_per_device,
                note=spec.note, groups=groups)
json.dump(out, sys.stdout)
"""


def _stub(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


@pytest.fixture(scope="module")
def reference():
    """``{level: {"arch|shape|mesh": figures}}`` of the reference's 72
    cells, one subprocess per level, both running at once."""
    procs = {}
    for level in ("0", "1"):
        env = dict(os.environ, REPRO_OPT_LEVEL=level, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                       p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs[level] = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for level, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        out[level] = json.loads(stdout)
    return out


def test_registry_cells_and_skip_reasons_match_the_reference():
    import repro.configs as jc

    import repro_torch.configs as tc

    assert tc.ARCH_NAMES == jc.ARCH_NAMES
    assert tc.all_cells() == jc.all_cells()
    assert len(tc.all_cells()) == 40
    for name in tc.ARCH_NAMES:
        arch, jarch = tc.get_arch(name), jc.get_arch(name)
        assert arch.name == jarch.name == name
        assert arch.family == jarch.family
        assert arch.shapes() == jarch.shapes()
        for shape in arch.shapes():
            assert arch.skip_reason(shape) == jarch.skip_reason(shape)
        if arch.family == "lm":
            assert isinstance(arch, tc.LMArch)
            for f in ("sub_quadratic", "train_microbatches", "moment_dtype"):
                assert getattr(arch, f) == getattr(jarch, f), (name, f)
    skipped = {c for c in tc.all_cells() if tc.get_arch(c[0]).skip_reason(c[1])}
    assert skipped == {(n, "long_500k") for n in (
        "gemma-2b", "phi3-mini-3.8b", "qwen3-4b", "deepseek-v3-671b")}


def test_paper_configs_match_field_for_field():
    import repro.configs.paper as jp

    import repro_torch.configs.paper as tp

    for cls in ("ListRankConfig", "CCConfig"):
        got, want = getattr(tp, cls), getattr(jp, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
            (f.name, f.default) for f in dataclasses.fields(want)]
        assert got.__dataclass_params__.frozen
    assert dataclasses.asdict(tp.LISTRANK_DEFAULT) == dataclasses.asdict(jp.LISTRANK_DEFAULT)
    assert dataclasses.asdict(tp.CC_DEFAULT) == dataclasses.asdict(jp.CC_DEFAULT)


ZERO_CASES = [
    # (spec, shape, mesh, extra axes)
    ((None, None, "model"), (36, 2560, 4096), "single", ("data",)),
    ((None, "model"), (2560, 4096), "multi", ("pod", "data")),
    (("model", None), (151936, 2560), "multi", ("pod", "data")),
    ((), (2560,), "single", ("data",)),
    ((), (48,), "multi", ("pod", "data")),  # only "pod" divides: the fallback
    ((), (7,), "multi", ("pod", "data")),  # nothing divides: unchanged
    ((("data", "model"), None, None), (256, 7168, 2048), "single", ("data",)),
    ((None, "model"), (4096, 16), "single", ("data", "absent")),
]


@pytest.mark.parametrize("spec,shape,mesh,extra", ZERO_CASES)
def test_zero_spec_matches_the_reference(spec, shape, mesh, extra):
    from jax.sharding import PartitionSpec as P

    from repro.configs.common import zero_spec as jzero
    from repro_torch.configs.common import zero_spec

    m = _stub(mesh)
    assert zero_spec(spec, shape, m, extra) == tuple(jzero(P(*spec), shape, m, extra))


def _port_figures(mesh_name):
    from repro_torch.configs import ARCH_NAMES, get_arch
    from repro_torch.configs.common import bytes_per_rank

    mesh = _stub(mesh_name)
    out = {}
    for a in ARCH_NAMES:
        arch = get_arch(a)
        for s in arch.shapes():
            if arch.skip_reason(s):
                continue
            spec = arch.build(s, mesh)
            args, specs = spec.args, spec.in_specs
            groups = {"params": bytes_per_rank(args[0], specs[0], mesh)}
            if isinstance(args[1], dict) and "step" in args[1]:
                for k in ("step", "m", "v"):
                    groups[k] = bytes_per_rank(args[1][k], specs[1][k], mesh)
                groups["batch"] = bytes_per_rank(args[2], specs[2], mesh)
            elif len(args) == 3:
                groups["cache"] = bytes_per_rank(args[1], specs[1], mesh)
                groups["batch"] = bytes_per_rank(args[2], specs[2], mesh)
            else:
                groups["batch"] = bytes_per_rank(args[1], specs[1], mesh)
            out[f"{a}|{s}|{mesh_name}"] = dict(
                model_flops_total=spec.model_flops_total,
                flops_total=spec.flops_total,
                hbm_bytes_per_device=spec.hbm_bytes_per_device,
                note=spec.note, groups=groups)
    return out


@pytest.mark.parametrize("level", ["0", "1"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_built_specs_match_the_reference_on_the_production_meshes(
        reference, monkeypatch, level, mesh):
    monkeypatch.setenv("REPRO_OPT_LEVEL", level)
    got = _port_figures(mesh)
    want = {k: v for k, v in reference[level].items() if k.endswith(f"|{mesh}")}
    assert len(got) == 36 and sorted(got) == sorted(want)
    for key, fig in got.items():
        assert fig == want[key], key
