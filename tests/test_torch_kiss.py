"""The port's KISS streams and input generators equal ``repro.ops.kiss``
bit for bit: they are what carries a seed's graph, list and splitters
across the two packages."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.ops import kiss as ref  # noqa: E402
from repro_torch.ops import kiss as port  # noqa: E402


@pytest.mark.parametrize("seed,streams", [(0, 1), (7, 33), (123456789, 8192)])
def test_kiss_streams_equal(seed, streams):
    a, b = ref.KissRng(seed, streams), port.KissRng(seed, streams)
    for _ in range(5):
        np.testing.assert_array_equal(a.next_u32(), b.next_u32())
    np.testing.assert_array_equal(
        a.uniform_ints((3, 1000), 977), b.uniform_ints((3, 1000), 977)
    )


@pytest.mark.parametrize(
    "name,args",
    [
        ("random_linked_list", (1, 0)),
        ("random_linked_list", (5000, 3)),
        ("list_graph", (3000, 7, 1)),
        ("tree_graph", (2000, 3, 2)),
        ("random_graph", (600, 0.01, 4)),
        ("random_forest", (3000, 9, 4, 5)),
        ("giant_dust_graph", (4000, 0.9, 6)),
    ],
)
def test_generators_equal(name, args):
    want = getattr(ref, name)(*args)
    got = getattr(port, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
