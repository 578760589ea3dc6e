"""The port stands alone: importing every ``repro_torch`` module loads no
jax and nothing of ``repro``, and ``chip_smoke.py`` imports neither."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"names": names, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = json.loads(subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=ROOT, check=True, timeout=120,
    ).stdout)
    assert len(out["names"]) >= 20, "walked too few modules"
    # the walk reaches every subpackage, the sharded graph engine, the
    # GNN, sampler and RecSys modules, the MoE LMs' modules, the training
    # package and the sharded-training modules too
    assert {"repro_torch.distributed", "repro_torch.distributed.graph",
            "repro_torch.ops.neighbor_sampler", "repro_torch.ops.embedding_bag",
            "repro_torch.data.recsys", "repro_torch.models.tree",
            "repro_torch.models.gnn.extra", "repro_torch.models.gnn.so3",
            "repro_torch.models.gnn.egnn", "repro_torch.models.gnn.mace",
            "repro_torch.models.recsys.xdeepfm", "repro_torch.models.recsys.convert",
            "repro_torch.configs.egnn", "repro_torch.configs.mace",
            "repro_torch.configs.recsys_family", "repro_torch.configs.xdeepfm",
            "repro_torch.models.transformer.moe", "repro_torch.data.lm",
            "repro_torch.data.pipeline", "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.deepseek_v3", "repro_torch.train",
            "repro_torch.train.optimizer", "repro_torch.train.compression",
            "repro_torch.train.checkpoint", "repro_torch.train.loop",
            "repro_torch.train.tree", "repro_torch.train.elastic",
            "repro_torch.distributed.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.collectives", "repro_torch.distributed.pipeline",
            "repro_torch.launch", "repro_torch.launch.mesh",
            "repro_torch.ops.sharded_lookup", "repro_torch.configs.lm_family",
            } <= set(out["names"])
    assert out["bad"] == []


@pytest.mark.parametrize(
    "path", ["chip_smoke.py"] + sorted(
        str(p.relative_to(ROOT)) for p in (ROOT / "src/repro_torch").rglob("*.py")
    ),
)
def test_no_source_of_the_port_imports_jax_or_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)
