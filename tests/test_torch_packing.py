"""The port's field packing layouts (``repro_torch.ops.packing``) against
the reference's ``repro.ops.packing``, bit for bit.

* AoS pack, unpack and row gather on the same int32 fields (negative
  values included), in this process.
* word64 pack and unpack against the reference's in one subprocess with
  ``jax_enable_x64`` on (a process-wide switch), as
  ``tests/test_word64.py`` runs it: the packed words equal as int64,
  and each side unpacks the other's words.
* ``bytes_per_node`` for every mode, and its error on an unknown one.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _fields(n=1000, seed=0):
    r = np.random.default_rng(seed)
    rank = r.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    owner = r.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    rank[:4] = [0, -1, 2**31 - 1, -2**31]
    owner[:4] = [-1, 0, -2**31, 2**31 - 1]
    idx = r.integers(0, n, 256).astype(np.int32)
    return rank, owner, idx


def test_aos_pack_unpack_and_gather_are_the_references_bit_for_bit():
    import jax.numpy as jnp

    from repro.ops import packing as jp
    from repro_torch.ops import packing as tp

    rank, owner, idx = _fields()
    got = tp.pack_aos(torch.from_numpy(rank), torch.from_numpy(owner))
    want = np.asarray(jp.pack_aos(jnp.asarray(rank), jnp.asarray(owner)))
    assert got.dtype == torch.int32 and got.shape == (1000, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tp.unpack_aos(got), jp.unpack_aos(jnp.asarray(want))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tp.gather_aos(got, torch.from_numpy(idx)),
                    jp.gather_aos(jnp.asarray(want), jnp.asarray(idx))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="shape mismatch"):
        tp.pack_aos(torch.zeros(3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))


_X64 = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import jax.numpy as jnp
    import torch
    sys.path.insert(0, {tests!r})
    from test_torch_packing import _fields
    from repro.ops import packing as jp
    from repro_torch.ops import packing as tp

    rank, owner, idx = _fields()
    want = np.asarray(jp.pack_word64(jnp.asarray(rank), jnp.asarray(owner)))
    got = tp.pack_word64(torch.from_numpy(rank), torch.from_numpy(owner))
    assert want.dtype == np.int64 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tp.unpack_word64(torch.from_numpy(want)),
                    jp.unpack_word64(jnp.asarray(got.numpy()))):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ra, oa = tp.unpack_word64(got[torch.from_numpy(idx).long()])
    np.testing.assert_array_equal(ra.numpy(), rank[idx])
    np.testing.assert_array_equal(oa.numpy(), owner[idx])
    print(json.dumps({{"ok": True, "n": int(want.size)}}))
""")


def test_word64_matches_the_reference_in_an_x64_subprocess():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", _X64.format(tests=str(ROOT / "tests"))],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"ok": True, "n": 1000}


@pytest.mark.parametrize("mode", ["soa", "aos", "word64"])
def test_bytes_per_node_matches_the_reference(mode):
    from repro.ops.packing import bytes_per_node as jbytes
    from repro_torch.ops.packing import bytes_per_node

    assert bytes_per_node(mode) == jbytes(mode)


def test_bytes_per_node_rejects_an_unknown_mode_as_the_reference():
    from repro.ops.packing import bytes_per_node as jbytes
    from repro_torch.ops.packing import bytes_per_node

    with pytest.raises(ValueError) as got:
        bytes_per_node("aosoa")
    with pytest.raises(ValueError) as want:
        jbytes("aosoa")
    assert str(got.value) == str(want.value)
