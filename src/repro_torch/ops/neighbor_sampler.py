"""CSR neighbor sampler for sampled GNN inference (the minibatch_lg
shape), the port's copy of ``repro/ops/neighbor_sampler.py``.

Host-side numpy over CSR, emitting fixed (fanout-padded) neighbor blocks
so the device graph is static-shaped. Draws come from the port's KISS
(``ops/kiss.py``), bit-identical to the reference's, so the same seed
samples the same blocks in both packages. Isolated nodes sample
themselves (self-loops), as in GraphSAGE's with-replacement sampling.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.ops.kiss import KissRng


def edges_to_csr(edges: np.ndarray, num_nodes: int, *,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrized CSR ``(indptr, indices)`` from an ``(m, 2)`` edge list.

    The stable sort by source is a ``torch.sort`` on ``device`` (the CPU
    by default; a card sorts the 229M entries of the full-size
    minibatch_lg graph in well under a second), copied back to numpy."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    keys, order = torch.sort(torch.from_numpy(src).to(device or "cpu"), stable=True)
    src = keys.cpu().numpy()
    dst = torch.from_numpy(dst).to(keys.device)[order].cpu().numpy()
    del keys, order
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst.astype(np.int32)


@dataclass
class SampledBlock:
    """One hop of sampled neighborhood.

    dst_nodes: (b,) destination node ids for this hop.
    src_nodes: (b * fanout,) sampled neighbor ids (with replacement;
        isolated nodes fall back to self-loops).
    dst_index: (b * fanout,) position of each sampled edge's destination
        in dst_nodes -- the segment ids of the aggregation.
    """

    dst_nodes: np.ndarray
    src_nodes: np.ndarray
    dst_index: np.ndarray


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self._rng = KissRng(seed, n_streams=8192)

    def sample_hop(self, nodes: np.ndarray, fanout: int) -> SampledBlock:
        b = len(nodes)
        deg = (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)
        draws = self._rng.uniform_ints((b, fanout), 1 << 31)
        # Uniform with replacement; degree-0 nodes become self-loops.
        safe_deg = np.maximum(deg, 1)
        offs = draws % safe_deg[:, None]
        gather = np.minimum(
            self.indptr[nodes][:, None] + offs, max(len(self.indices) - 1, 0)
        )
        src = (
            self.indices[gather]
            if len(self.indices)
            else np.broadcast_to(nodes[:, None], (b, fanout)).copy()
        )
        src = np.where(deg[:, None] == 0, nodes[:, None], src)
        dst_index = np.repeat(np.arange(b, dtype=np.int32), fanout)
        return SampledBlock(
            dst_nodes=nodes.astype(np.int32),
            src_nodes=src.reshape(-1).astype(np.int32),
            dst_index=dst_index,
        )

    def sample_multihop(
        self, seed_nodes: np.ndarray, fanouts: list[int]
    ) -> list[SampledBlock]:
        """GraphSAGE-style layered sampling: hop h expands hop h-1's
        sources."""
        blocks: list[SampledBlock] = []
        frontier = seed_nodes
        for fanout in fanouts:
            blk = self.sample_hop(frontier, fanout)
            blocks.append(blk)
            frontier = blk.src_nodes
        return blocks
