"""Multi-pod dry-run driver: the port of ``repro/launch/dryrun.py``.

For every (architecture x input shape) cell, build the step's spec for
the production mesh (single pod 16x16 = 256 GPUs, multi-pod 2x16x16 =
512), run the step once as rank 0 on meta tensors, count what it sends
through the port's collectives, and derive the roofline terms on the
H100 (``launch/roofline.py``).

Run one cell:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k --mesh single
Run everything (per-cell subprocesses, results appended to a JSON file):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out results/dryrun_torch.json

Where the reference forces 512 fake XLA devices before jax is imported
and lowers and compiles the step for them, a process here starts a
``fake`` process group of the mesh's size (256 or 512 ranks, this
process rank 0) before it builds anything: a ``Mesh`` on the meta device
runs on it (``distributed/mesh.py``), its collectives return at once on
meta tensors, and every kernel wrapper takes its plain version on meta
tensors, which computes shapes and nothing else. Running the step is the
counterpart of ``lower``: it runs the port's own code, so a step that
needs a value (``.item()``, a size that depends on the data) cannot run
and its record is an error with the exception, as the reference records
a failed compile.

A record holds ``lower_s`` (building the spec and running the step), the
roofline, and under ``roofline.memory_per_device`` the bytes one rank
holds of the arguments and of the outputs. XLA's compiler alone knows
``compile_s`` and the temporary and aliased buffers
(``temp_size_in_bytes``, ``alias_size_in_bytes``): the record leaves them
out, and its ``note`` says so.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

XLA_ONLY = "compile_s, temp_size_in_bytes and alias_size_in_bytes: XLA-only, not measured"


def start_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` group of ``world`` ranks
    (once; a group of another kind or size raises). The fake backend is
    private torch API (``torch.testing._internal.distributed.fake_pg``),
    imported here and nowhere else; checked on torch 2.13.0 (CPU) and
    2.11.0 with CUDA 12.8."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(
            f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
            f"running; the dry run needs a fake group of {world}")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch_name: str, shape: str, multi_pod: bool, verbose: bool = True):
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import shard_args, tree_bytes
    from repro_torch.distributed.collectives import count_traffic
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_production_mesh, mesh_num_chips

    arch = get_arch(arch_name)
    skip = arch.skip_reason(shape)
    mesh_name = "multi" if multi_pod else "single"
    base = {"arch": arch_name, "shape": shape, "mesh": mesh_name}
    if skip:
        return base | {"status": "skip", "reason": skip}

    start_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = mesh_num_chips(mesh)
    t0 = time.time()
    spec = arch.build(shape, mesh)
    args = shard_args(spec.args, spec.in_specs, mesh)
    with mesh, count_traffic() as traffic:
        out = spec.fn(*args)
    t_lower = time.time() - t0
    mem = {"argument_size_in_bytes": tree_bytes(args),
           "output_size_in_bytes": tree_bytes(out)}
    if verbose:
        print(f"== {arch_name} x {shape} on {mesh_name} ({chips} ranks) ==")
        print("memory_per_device:", mem)
        print("collectives:", traffic.bytes_by_op, traffic.count_by_op)

    roof = rl.analyze(spec, chips, traffic, memory_per_device=mem)
    note = f"{spec.note}; {XLA_ONLY}" if spec.note else XLA_ONLY
    return base | {
        "status": "ok",
        "chips": chips,
        "lower_s": round(t_lower, 2),
        "note": note,
        "roofline": roof.as_dict(),
    }


def _run_all(out_path: str, meshes: list[str], only_arch: str | None = None):
    """Spawn one subprocess per cell (a fake group is process-wide, and
    one bad cell cannot kill the sweep)."""
    from repro_torch.configs import ARCH_NAMES, get_arch

    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}
    for arch_name in ARCH_NAMES:
        if only_arch and arch_name != only_arch:
            continue
        arch = get_arch(arch_name)
        for shape in arch.shapes():
            for mesh_name in meshes:
                key = (arch_name, shape, mesh_name)
                if key in done:
                    continue
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch_name, "--shape", shape,
                    "--mesh", mesh_name, "--json",
                ]
                print(">>", " ".join(cmd), flush=True)
                t0 = time.time()
                proc = subprocess.run(
                    cmd, capture_output=True, text=True, timeout=3600
                )
                dt = time.time() - t0
                rec = None
                for line in reversed(proc.stdout.splitlines()):
                    if line.startswith("{"):
                        try:
                            rec = json.loads(line)
                            break
                        except json.JSONDecodeError:
                            continue
                if rec is None:
                    rec = {
                        "arch": arch_name, "shape": shape, "mesh": mesh_name,
                        "status": "error",
                        "error": proc.stderr[-2000:],
                        "wall_s": round(dt, 1),
                    }
                results.append(rec)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
                print(f"   -> {rec['status']} ({dt:.0f}s)", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--json", action="store_true",
                    help="print a single JSON record on the last line")
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        meshes = ["single", "multi"]
        results = _run_all(args.out, meshes, only_arch=args.arch)
        ok = sum(r["status"] == "ok" for r in results)
        skip = sum(r["status"] == "skip" for r in results)
        err = sum(r["status"] == "error" for r in results)
        print(f"dry-run sweep: {ok} ok, {skip} skip, {err} error")
        sys.exit(1 if err else 0)

    # The fake group comes first, as the reference sets XLA_FLAGS first.
    start_fake_group(512 if args.mesh == "multi" else 256)
    try:
        rec = run_cell(
            args.arch, args.shape, args.mesh == "multi", verbose=not args.json
        )
    except Exception:
        traceback.print_exc()
        rec = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "status": "error", "error": traceback.format_exc()[-2000:],
        }
    print(json.dumps(rec))
    sys.exit(0 if rec["status"] in ("ok", "skip") else 1)


if __name__ == "__main__":
    main()
