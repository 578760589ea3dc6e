"""MACE (higher-order equivariant message passing), arXiv:2206.07697, the
port of ``repro/models/gnn/mace.py``: forward and ``loss_fn``.

l_max = 2 irreps, correlation order 3, a Bessel radial basis with a
polynomial cutoff, real-basis CG tensor products (``so3.py``), and
per-layer invariant readouts summed into a total energy:

  A-basis  A_i^{L} = sum_j R_path(r_ij) * CG(l1,l2,L) h_j^{l1} Y_{l2}(r_ij)
  B-basis  products of A up to correlation 3 via nested CG contractions
  update   h'^{L} = W_A A^{L} + W_B B^{L} + W_res h^{L}

Features are lists indexed by l: ``feats[l]`` has shape (n, C, 2l+1).

Two contractions are ordered so that no large outer product is made:
an edge path contracts ``Y_{l2}`` with the CG tensor first, (m, a, z),
and then the gathered features with that, one (C, a) x (a, z) product a
edge (``torch.bmm``), where a one-shot einsum would make an
(m, C, a, b) tensor (3.4 GB a path at m = 262,144, C = 128); a node
product (the B-basis) sums over ``a`` of ``x[..., a] * (y @ CG[a])``,
never the (n, C, a, b) outer product. The message paths that land on
the same L are added on the edges before their one sum over edges, the
``segment_sum`` kernel at (m, C, 2L+1): three launches a layer, one more
for the energy readout over ``graph_ids``. Sums are linear, so this is
the reference's function (a path per sum there). So is taking each
path's radial weights from its own columns of ``rad_w2`` rather than
making all of them at once, (m, P, C): 2 GB at that size and P = 15.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import he_init, input_tensor
from repro_torch.models.gnn.graph import dst_sorted_edges, is_sorted
from repro_torch.models.gnn.so3 import cg_tensor, num_m, real_sph_harm
from repro_torch.models.tree import ParamTree, empty_tree, generator_on
from repro_torch.ops.segment import edge_parallel_loss, segment_sum, segment_sum_dist


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    num_layers: int = 2
    channels: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    num_species: int = 10
    r_cut: float = 5.0
    dtype: str = "float32"


def _msg_paths(ls_in: list[int], l_max: int) -> list[tuple[int, int, int]]:
    paths = []
    for l1 in ls_in:
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2:
                    paths.append((l1, l2, l3))
    return paths


def _prod2_paths(l_max: int) -> list[tuple[int, int, int]]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l1, l_max + 1):
            for lo in range(l_max + 1):
                if abs(l1 - l2) <= lo <= l1 + l2:
                    out.append((l1, l2, lo))
    return out


def _prod3_paths(l_max: int) -> list[tuple[int, int, int, int, int]]:
    out = []
    for l1, l2, l12 in _prod2_paths(l_max):
        for l3 in range(l_max + 1):
            for lo in range(l_max + 1):
                if abs(l12 - l3) <= lo <= l12 + l3:
                    out.append((l1, l2, l12, l3, lo))
    return out


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff (DimeNet-style)."""
    rs = r.clamp(1e-6, r_cut)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = (math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * rs[:, None] / r_cut)
             / rs[:, None])
    u = (r / r_cut).clamp(0.0, 1.0)[:, None]
    envelope = 1.0 - 10.0 * u ** 3 + 15.0 * u ** 4 - 6.0 * u ** 5
    return basis * envelope


def _layer_ls(cfg: MACEConfig) -> list[list[int]]:
    """The irreps each layer reads: l = 0 first, then 0..l_max."""
    return [[0] if i == 0 else list(range(cfg.l_max + 1))
            for i in range(cfg.num_layers)]


def param_spec(cfg: MACEConfig) -> dict:
    c = cfg.channels
    layers = []
    for ls_in in _layer_ls(cfg):
        n_paths = len(_msg_paths(ls_in, cfg.l_max))
        layers.append({
            "rad_w1": (cfg.n_rbf, 64),
            "rad_b1": (64,),
            "rad_w2": (64, n_paths * c),
            "mix_pre": [(c, c)] * len(ls_in),
            "w_A": [(c, c)] * (cfg.l_max + 1),
            "w_B2": (len(_prod2_paths(cfg.l_max)), c),
            "w_B3": ((len(_prod3_paths(cfg.l_max)), c)
                     if cfg.correlation >= 3 else None),
            "w_res": [(c, c)] * len(ls_in),
            "readout_w": (c, 1),
        })
    return {
        "species_embed": (cfg.num_species, c),
        "layers": layers,
        "final_w1": (c, 16),
        "final_w2": (16, 1),
    }


@torch.no_grad()
def init_params(cfg: MACEConfig, *, generator: torch.Generator | None = None,
                device=None) -> ParamTree:
    """Random parameters with the reference's scales: He-truncated normal
    matrices, zero ``rad_b1`` and ``final_w2``, normal ``species_embed``
    (x 0.5), ``w_B2`` (x 0.1) and ``w_B3`` (x 0.03). Drawn from
    ``generator`` (else one seeded with 0 on ``device``)."""
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    dtype = getattr(torch, cfg.dtype)
    params = empty_tree(param_spec(cfg), dev, dtype)

    def he(p):
        p.copy_(he_init(gen, p.shape, p.shape[0], dtype))

    def normal(p, scale):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * scale)

    for layer in params["layers"]:
        he(layer["rad_w1"])
        layer["rad_b1"].zero_()
        he(layer["rad_w2"])
        for w in (*layer["mix_pre"], *layer["w_A"], *layer["w_res"]):
            he(w)
        normal(layer["w_B2"], 0.1)
        if layer["w_B3"] is not None:
            normal(layer["w_B3"], 0.03)
        he(layer["readout_w"])
    normal(params["species_embed"], 0.5)
    he(params["final_w1"])
    params["final_w2"].zero_()
    return params


def _cg(l1, l2, l3, like: torch.Tensor) -> torch.Tensor:
    return cg_tensor(l1, l2, l3, like.dtype, str(like.device))


def _couple(x: torch.Tensor, y: torch.Tensor, cg: torch.Tensor) -> torch.Tensor:
    """``einsum("nca,ncb,abo->nco", x, y, cg)`` as a sum over ``a`` of
    ``x[..., a] * (y @ cg[a])``: no (n, C, a, b) tensor."""
    out = None
    for a in range(cg.shape[0]):
        term = x[..., a:a + 1] * (y @ cg[a])
        out = term if out is None else out + term
    return out


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ncm,cd->ndm", x, w)``: a channel mix of (n, C, 2l+1)."""
    return torch.einsum("ncm,cd->ndm", x, w)


def forward(params: ParamTree, cfg: MACEConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = (), constrain=None) -> torch.Tensor:
    """graph: ``species`` (n,) int, ``positions`` (n, 3), ``src``/``dst``
    (m,), ``graph_ids`` and ``num_graphs``. Returns per-graph energies
    (num_graphs,) in float32, on the parameters' device.

    ``constrain(tensor, kind)``, kind in {"mix_in", "node", "edge"}, is
    the reference's hook for pinning shardings, applied to the same
    tensors (the layer's input features, the mixed node features, each
    edge contribution, each aggregate). On explicit ranks a layout is
    fixed where a tensor is made, so it is a layout hook whose result is
    used in place of its input: values are unchanged."""
    C_ = constrain or (lambda t, kind: t)
    dev = params["final_w1"].device
    species = input_tensor(graph, "species", dev)
    x = input_tensor(graph, "positions", dev).float()
    src, dst = dst_sorted_edges(graph, dev)
    n = species.shape[0]
    m = src.shape[0]
    c = cfg.channels

    vec = x.index_select(0, dst) - x.index_select(0, src)
    r = torch.sqrt(torch.sum(vec * vec, dim=-1).clamp_min(1e-12))
    rhat = vec / r[:, None]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.r_cut)  # (m, n_rbf)
    sh = [real_sph_harm(l, rhat) for l in range(cfg.l_max + 1)]  # (m, 2l+1)
    del vec, rhat, r

    h0 = params["species_embed"].index_select(0, species.long())  # (n, C)
    feats = [h0[:, :, None]]  # l = 0 only
    energy_nodes = torch.zeros((n,), dtype=torch.float32, device=dev)

    for ls_in, layer in zip(_layer_ls(cfg), params["layers"]):
        mpaths = _msg_paths(ls_in, cfg.l_max)
        rad = F.silu(rbf @ layer["rad_w1"] + layer["rad_b1"])  # (m, 64)
        pre = [C_(_mix(C_(feats[i], "mix_in"), layer["mix_pre"][i]), "node")
               for i in range(len(ls_in))]

        # ---- A-basis: message passing with CG couplings ----
        edge_sum = [None] * (cfg.l_max + 1)
        for pi, (l1, l2, l3) in enumerate(mpaths):
            cg = _cg(l1, l2, l3, h0)  # (a, b, z)
            a, b, z = cg.shape
            # Y_{l2} with the CG tensor first: (m, a, z).
            ycg = (sh[l2] @ cg.permute(1, 0, 2).reshape(b, a * z)).reshape(m, a, z)
            hj = pre[ls_in.index(l1)].index_select(0, src)  # (m, C, a)
            # The path's radial weights: its C columns of rad_w2, (m, C).
            rad_p = rad @ layer["rad_w2"][:, pi * c:(pi + 1) * c]
            contrib = C_(torch.bmm(hj, ycg) * rad_p[:, :, None], "edge")  # (m, C, z)
            del hj, ycg, rad_p
            edge_sum[l3] = contrib if edge_sum[l3] is None else edge_sum[l3] + contrib
            del contrib
        A = []
        for l in range(cfg.l_max + 1):
            if edge_sum[l] is None:
                A.append(torch.zeros((n, c, num_m(l)), dtype=h0.dtype, device=dev))
            else:
                A.append(C_(segment_sum_dist(edge_sum[l], dst, n, psum_axes,
                                             indices_are_sorted=True), "node"))
            edge_sum[l] = None
        del rad, pre

        # ---- B-basis: symmetric products (correlation 2 and 3) ----
        msg = [_mix(A[l], layer["w_A"][l]) for l in range(cfg.l_max + 1)]
        for pi, (l1, l2, lo) in enumerate(_prod2_paths(cfg.l_max)):
            b2 = _couple(A[l1], A[l2], _cg(l1, l2, lo, h0))
            msg[lo] = msg[lo] + b2 * layer["w_B2"][pi][None, :, None]
        if layer["w_B3"] is not None:
            for pi, (l1, l2, l12, l3, lo) in enumerate(_prod3_paths(cfg.l_max)):
                t = _couple(A[l1], A[l2], _cg(l1, l2, l12, h0))
                b3 = _couple(t, A[l3], _cg(l12, l3, lo, h0))
                msg[lo] = msg[lo] + b3 * layer["w_B3"][pi][None, :, None]
        del A

        # ---- update + residual ----
        new_feats = []
        for l in range(cfg.l_max + 1):
            f = msg[l]
            if l in ls_in:
                f = f + _mix(feats[ls_in.index(l)], layer["w_res"][l])
            new_feats.append(f)
        feats = new_feats

        # ---- per-layer invariant readout ----
        energy_nodes = energy_nodes + (feats[0][:, :, 0] @ layer["readout_w"])[:, 0].float()

    h_inv = feats[0][:, :, 0]
    final = F.silu(h_inv @ params["final_w1"]) @ params["final_w2"]
    energy_nodes = energy_nodes + final[:, 0].float()
    gid = input_tensor(graph, "graph_ids", dev)
    return segment_sum(energy_nodes, gid, int(graph["num_graphs"]),
                       indices_are_sorted=is_sorted(gid))


def loss_fn(params: ParamTree, cfg: MACEConfig, graph: dict, *,
            psum_axes: tuple[str, ...] = (), constrain=None) -> torch.Tensor:
    """Mean squared error of the energies against ``graph["labels"]``."""
    pred = forward(params, cfg, graph, psum_axes=psum_axes, constrain=constrain)
    target = input_tensor(graph, "labels", pred.device).float()
    return edge_parallel_loss(torch.mean((pred - target) ** 2), psum_axes)
