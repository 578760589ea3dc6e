"""The edge_hook kernel's layout, stated plainly in
``kernels/edge_hook/ref.py::edge_hook_packed_ref`` (sv2's packed label
words and stamp bytes, sv3's root bits), against the
plain version ``edge_hook_ref`` and ``repro``'s Pallas kernel in
interpret mode, bit for bit: on random states (stamps above ``s``
included), a chain's round states, a star whose every hook targets one
root, duplicate edges and no edges."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.edge_hook.ops import edge_hook as jax_edge_hook  # noqa: E402
from repro_torch.core.components import sv_round_fns  # noqa: E402
from repro_torch.kernels.edge_hook.ref import (  # noqa: E402
    LABEL_BITS,
    bit_of,
    drop_scatter_fill,
    edge_hook_packed_ref,
    edge_hook_ref,
    root_bits,
    stagnant_words,
    stamp_bytes,
    stamps_from_bytes,
)

S = 3


def _random_state(n, m, seed):
    """Random edges and labels; ``labels_prev`` equal to the labels at
    about half the nodes (so sv2's stagnant test splits), stamps in
    ``[0, 2 * S)``, above ``S`` at a third of the nodes."""
    r = np.random.default_rng(seed)
    a = r.integers(0, n, m)
    b = r.integers(0, n, m)
    labels = r.integers(0, n, n)
    prev = np.where(r.random(n) < 0.5, labels, r.integers(0, n, n))
    stamps = r.integers(0, 2 * S, n)
    return [torch.from_numpy(x.astype(np.int32)) for x in (a, b, labels, prev, stamps)]


def _chain_states(n):
    """The first and a later SV round state of the path 0-1-...-(n-1)
    as the hook phases see it (the chip check's ``hook_states``)."""
    src = torch.arange(n - 1, dtype=torch.int32)
    a, b = torch.cat([src, src + 1]), torch.cat([src + 1, src])
    D = torch.arange(n, dtype=torch.int32)
    Q = torch.zeros(n, dtype=torch.int32)
    states = [(a, b, D[D], D, Q, 1)]
    body = sv_round_fns(a, b, n, hook_impl="torch")
    s, hooks = 1, None
    for _ in range(2):
        D, Q, hooks, s, _changed = body((D, Q, hooks, s, True))
    D1 = D[D]
    states.append((a, b, D1, D, drop_scatter_fill(Q, torch.where(D1 != D, D1, n), s), s))
    return states


def _star(n):
    """Every edge runs from the largest node to a leaf, leaves in
    descending order; with identity labels every hook of both phases
    targets node ``n - 1``."""
    b = torch.arange(n - 2, -1, -1, dtype=torch.int32)
    a = torch.full_like(b, n - 1)
    D = torch.arange(n, dtype=torch.int32)
    return a, b, D, D, torch.zeros(n, dtype=torch.int32), 1


def _duplicates(n, m, seed):
    a, b, labels, prev, stamps = _random_state(n, m, seed)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(3 * m))
    return (torch.cat([a, a, b])[perm], torch.cat([b, b, a])[perm], labels,
            prev, stamps, S)


def _cases():
    cases = {}
    for n, m in ((64, 300), (1000, 777), (33, 4000)):
        a, b, labels, prev, stamps = _random_state(n, m, 7 * n + m)
        cases[f"random-{n}-{m}"] = (a, b, labels, prev, stamps, S)
    for k, state in enumerate(_chain_states(200)):
        cases[f"chain-state{k}"] = state
    cases["star"] = _star(1000)
    cases["duplicates"] = _duplicates(100, 400, 5)
    empty = torch.zeros(0, dtype=torch.int32)
    _, _, labels, prev, stamps = _random_state(50, 0, 1)
    cases["no-edges"] = (empty, empty, labels, prev, stamps, S)
    return cases


CASES = _cases()


def _pallas(a, b, labels, prev, stamps, s, mode):
    j = [jnp.asarray(x.numpy()) for x in (a, b, labels, prev, stamps)]
    return jax_edge_hook(j[0], j[1], j[2], j[4], jnp.int32(s), labels_prev=j[3],
                         mode=mode, impl="pallas_interpret", block_e=128)


@pytest.mark.parametrize("mode", ["sv2", "sv3"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_layout_equals_plain_version_and_pallas(case, mode):
    a, b, labels, prev, stamps, s = CASES[case]
    got_d, got_x = edge_hook_packed_ref(a, b, labels, prev, stamps, s, mode=mode)
    want_d, want_x = edge_hook_ref(a, b, labels, prev, stamps, s, mode=mode)
    pallas_d, pallas_q = _pallas(a, b, labels, prev, stamps, s, mode)
    assert got_d.dtype == torch.int32 and got_x.dtype == want_x.dtype
    assert torch.equal(got_d, want_d) and torch.equal(got_x, want_x)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(pallas_d))
    if mode == "sv2":
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(pallas_q))
    else:
        assert torch.equal(got_x, labels[a] != labels[b])


def test_star_hooks_every_edge_into_one_root():
    a, b, labels, prev, stamps, s = CASES["star"]
    n = labels.shape[0]
    d2, q2 = edge_hook_packed_ref(a, b, labels, prev, stamps, s, mode="sv2")
    d3, _ = edge_hook_packed_ref(a, b, labels, prev, stamps, s, mode="sv3")
    for d in (d2, d3):
        assert int(d[n - 1]) == 0 and torch.equal(d[:-1], labels[:-1])
    assert torch.equal(q2[:-1], torch.full((n - 1,), s, dtype=torch.int32))


def test_packed_words_and_root_bits_hold_their_tests():
    _, _, labels, prev, stamps = _random_state(500, 0, 3)
    node = torch.arange(500, dtype=torch.int32)
    labels = torch.where(node % 3 == 0, node, labels)  # some roots
    p = stagnant_words(labels, prev)
    assert int(p.min()) >= 0 and int(p.max()) < 2**32
    assert torch.equal(p & LABEL_BITS, labels.long())
    stagnant = labels == prev
    assert torch.equal(p >> 31 == 1, stagnant) and 0 < int(stagnant.sum()) < 500
    bits = root_bits(labels, stamps, S)
    root = (stamps < S) & (labels == node)
    assert bits.shape == (16,) and int(bits.max()) < 2**32
    assert torch.equal(bit_of(bits, node), root) and 0 < int(root.sum()) < 500


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000])
def test_stamp_bytes_epilogue_is_the_scatter_fill(n):
    r = np.random.default_rng(n)
    nodes = torch.from_numpy(r.integers(0, n, 3 * n).astype(np.int32))
    stamps = torch.from_numpy(r.integers(0, 2 * S, n).astype(np.int32))
    stamped = stamp_bytes(nodes, n)
    assert stamped.dtype == torch.uint8 and stamped.shape == (n,)
    assert torch.equal(stamps_from_bytes(stamped, stamps, S),
                       drop_scatter_fill(stamps, nodes, S))
