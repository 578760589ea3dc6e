"""xDeepFM (arXiv:1803.05170): linear + CIN + DNN over field embeddings,
the port of ``repro/models/recsys/xdeepfm.py``: forward, serving and
``loss_fn``.

Config: 39 sparse fields, embed_dim 10, CIN 200-200-200, MLP 400-400.
The embedding tables are ONE stacked (n_fields * vocab, dim) table on
the device, and a lookup is one row gather per (field, id).

CIN (Compressed Interaction Network):
  x^{k+1}_{h} = sum_{i,j} W^{k}_{h,i,j} (x^k_i o x^0_j)   (o = Hadamard over D)
with per-layer sum pooling over D into the final logit. The reference
writes a layer as one einsum, ``"bhd,bmd,ohm->bod"``, which contracted
pairwise makes a (B, H, m, D) tensor: 82 GB at B = 262,144. Here a
layer runs over chunks of rows: each chunk's (rows, D, H*m) Hadamard
products times the (H*m, o) weights, one matrix product, so no chunk
holds more than ``CIN_CHUNK_BYTES`` of products (``cin_chunk_rows``).
The same function, summed in another order.

The retrieval head scores one user against the candidate tower with a
factorised dot product, (1, r) @ (r, n_candidates), and ``torch.topk``.

With a ``mesh`` whose ``"model"`` axis splits the rows of ``table``,
``linear`` and ``cand_embed`` (``configs/recsys_family.py::
recsys_param_specs``: this rank holds a block of each), a lookup is
``ops/sharded_lookup.py::sharded_row_gather`` over ``"model"`` and the
retrieval scores this rank's candidates, then gathers every rank's
scores before the top-k. ``batch_axes`` names the mesh axes the batch
rows are split over, of which ``batch`` holds this rank's block; the
loss is then the whole batch's mean.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import he_init, input_tensor
from repro_torch.models.tree import ParamTree, empty_tree, generator_on

# The most bytes of Hadamard products one CIN chunk holds.
CIN_CHUNK_BYTES = 1 << 30


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    retrieval_dim: int = 64
    n_candidates: int = 1_000_000
    dtype: str = "float32"


def param_spec(cfg: XDeepFMConfig) -> dict:
    rows = cfg.n_fields * cfg.vocab_per_field
    cin, h_prev = [], cfg.n_fields
    for h in cfg.cin_layers:
        cin.append((h, h_prev, cfg.n_fields))
        h_prev = h
    mlp, d_in = [], cfg.n_fields * cfg.embed_dim
    for d_out in cfg.mlp_layers:
        mlp.append({"w": (d_in, d_out), "b": (d_out,)})
        d_in = d_out
    return {
        "table": (rows, cfg.embed_dim),
        "linear": (rows, 1),
        "bias": (),
        "cin": cin,
        "cin_out": (sum(cfg.cin_layers), 1),
        "mlp": mlp,
        "mlp_out": (d_in, 1),
        "retrieval_proj": (d_in, cfg.retrieval_dim),
        "cand_embed": (cfg.n_candidates, cfg.retrieval_dim),
    }


@torch.no_grad()
def init_params(cfg: XDeepFMConfig, *, generator: torch.Generator | None = None,
                device=None) -> ParamTree:
    """Random parameters with the reference's scales: normal tables
    (x 0.01, the candidate tower x 0.05), He-truncated normal matrices
    (a CIN layer's fan-in is H_prev * n_fields), zero biases. Drawn from
    ``generator`` (else one seeded with 0 on ``device``)."""
    dev = resolve_device(device)
    gen = generator_on(generator, dev)
    dtype = getattr(torch, cfg.dtype)
    p = empty_tree(param_spec(cfg), dev, dtype)

    def he(w, fan_in):
        w.copy_(he_init(gen, w.shape, fan_in, dtype))

    def normal(w, scale):
        w.copy_(torch.randn(w.shape, generator=gen, device=dev) * scale)

    normal(p["table"], 0.01)
    normal(p["linear"], 0.01)
    p["bias"].zero_()
    for w in p["cin"]:
        he(w, w.shape[1] * w.shape[2])
    he(p["cin_out"], p["cin_out"].shape[0])
    for layer in p["mlp"]:
        he(layer["w"], layer["w"].shape[0])
        layer["b"].zero_()
    he(p["mlp_out"], p["mlp_out"].shape[0])
    he(p["retrieval_proj"], p["retrieval_proj"].shape[0])
    normal(p["cand_embed"], 0.05)
    return p


def _rows(params: ParamTree, cfg: XDeepFMConfig, batch: dict) -> torch.Tensor:
    """(B, n_fields) ids offset into the stacked table, int64 on the
    parameters' device."""
    ids = input_tensor(batch, "sparse_ids", params["table"].device).long()
    offsets = torch.arange(cfg.n_fields, device=ids.device) * cfg.vocab_per_field
    return ids + offsets[None, :]


def _split(params: ParamTree, cfg: XDeepFMConfig, mesh) -> bool:
    """Whether this rank holds a block of the tables' rows."""
    return (mesh is not None
            and params["table"].shape[0] != cfg.n_fields * cfg.vocab_per_field)


def _gather(table: torch.Tensor, rows: torch.Tensor, split: bool, mesh) -> torch.Tensor:
    """(B, n_fields) rows of ``table`` -> (B, n_fields, width)."""
    if split:
        from repro_torch.ops.sharded_lookup import sharded_row_gather

        return sharded_row_gather(table, rows, mesh, "model")
    return table.index_select(0, rows.reshape(-1)).reshape(*rows.shape, table.shape[1])


def _lookup(params: ParamTree, cfg: XDeepFMConfig, rows: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """(B, n_fields) table rows -> (B, n_fields, D) embeddings."""
    return _gather(params["table"], rows, _split(params, cfg, mesh), mesh)


def cin_chunk_rows(h: int, m: int, d: int, itemsize: int = 4,
                   budget: int = CIN_CHUNK_BYTES) -> int:
    """Rows of a CIN chunk whose (rows, D, H*m) products fit ``budget``."""
    return max(1, budget // (h * m * d * itemsize))


def cin_layer(xk: torch.Tensor, x0: torch.Tensor, w: torch.Tensor, *,
              budget: int = CIN_CHUNK_BYTES) -> torch.Tensor:
    """``einsum("bhd,bmd,ohm->bod", xk, x0, w)`` in chunks of rows: per
    chunk the (rows, D, H, m) Hadamard products, flattened to
    (rows * D, H * m), times ``w`` as (H * m, o)."""
    b, h, d = xk.shape
    m, o = x0.shape[1], w.shape[0]
    w2 = w.reshape(o, h * m).T
    out = torch.empty((b, o, d), dtype=xk.dtype, device=xk.device)
    step = cin_chunk_rows(h, m, d, xk.element_size(), budget)
    for s in range(0, b, step):
        a = xk[s:s + step].transpose(1, 2)  # (rows, D, H)
        c = x0[s:s + step].transpose(1, 2)  # (rows, D, m)
        z = (a[..., :, None] * c[..., None, :]).reshape(-1, h * m)
        out[s:s + step] = (z @ w2).reshape(-1, d, o).transpose(1, 2)
        del z
    return out


def _cin(params: ParamTree, x0: torch.Tensor) -> torch.Tensor:
    """x0: (B, m, D) -> pooled (B, sum(H_k))."""
    xk, pooled = x0, []
    for w in params["cin"]:
        xk = cin_layer(xk, x0, w)
        pooled.append(xk.sum(dim=-1))  # sum-pool over D
    return torch.cat(pooled, dim=-1)


def _dnn_hidden(params: ParamTree, x0_flat: torch.Tensor) -> torch.Tensor:
    h = x0_flat
    for layer in params["mlp"]:
        h = F.relu(h @ layer["w"] + layer["b"])
    return h


def forward(params: ParamTree, cfg: XDeepFMConfig, batch: dict, *,
            mesh=None) -> torch.Tensor:
    """``batch["sparse_ids"]``: (B, n_fields) -> logits (B,)."""
    rows = _rows(params, cfg, batch)
    b = rows.shape[0]
    split = _split(params, cfg, mesh)
    emb = _gather(params["table"], rows, split, mesh)  # (B, m, D)
    linear = _gather(params["linear"], rows, split, mesh).reshape(
        b, cfg.n_fields).sum(dim=-1)
    cin_logit = (_cin(params, emb) @ params["cin_out"])[:, 0]
    hidden = _dnn_hidden(params, emb.reshape(b, -1))
    dnn_logit = (hidden @ params["mlp_out"])[:, 0]
    return linear + cin_logit + dnn_logit + params["bias"]


def loss_fn(params: ParamTree, cfg: XDeepFMConfig, batch: dict, *,
            mesh=None, batch_axes: tuple = ()) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against
    ``batch["labels"]``, in the numerically stable form
    ``max(l, 0) - l y + log1p(exp(-|l|))``. With ``batch_axes`` the
    mean of the whole batch: the rows' sum is summed over the axes
    (passing the gradient through, so each rank's is its share) and
    divided by the whole batch's size."""
    logits = forward(params, cfg, batch, mesh=mesh).float()
    labels = input_tensor(batch, "labels", logits.device).float()
    bce = (torch.clamp(logits, min=0.0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if not batch_axes:
        return torch.mean(bce)
    from repro_torch.distributed.collectives import reduce_from

    total = reduce_from(bce.sum(), mesh, batch_axes)
    return total / (bce.shape[0] * mesh.axis_size(batch_axes))


def serve_step(params: ParamTree, cfg: XDeepFMConfig, batch: dict, *,
               mesh=None) -> torch.Tensor:
    """CTR scores in [0, 1] (the serve_p99 and serve_bulk shapes)."""
    return torch.sigmoid(forward(params, cfg, batch, mesh=mesh))


def serve_retrieval(params: ParamTree, cfg: XDeepFMConfig, batch: dict,
                    top_k: int = 100, *, mesh=None):
    """The retrieval_cand shape: one query scored against the candidate
    tower. ``batch["sparse_ids"]``: (1, n_fields). Returns (scores
    (n_candidates,), (top-k scores, top-k ids)); ties may be ordered
    otherwise than ``jax.lax.top_k`` orders them."""
    rows = _rows(params, cfg, batch)
    emb = _lookup(params, cfg, rows, mesh)
    hidden = _dnn_hidden(params, emb.reshape(emb.shape[0], -1))
    user = hidden @ params["retrieval_proj"]  # (1, r)
    scores = (user @ params["cand_embed"].T)[0]  # (n_candidates,)
    if mesh is not None and scores.shape[0] != cfg.n_candidates:
        from repro_torch.distributed.collectives import all_gather

        scores = all_gather(scores, mesh, "model", 0)
    top = torch.topk(scores, top_k)
    return scores, (top.values, top.indices)
