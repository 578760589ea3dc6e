#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100. Phases, each
of which raises on failure:

1. Device and build: the card's name and power limit, the torch
   version, and the seven CUDA kernels built from ``kernels/csrc`` (one
   ``nvcc`` per source, all at once; the build's seconds printed) with
   ``-Xptxas -v``'s registers, shared memory and spills; the bf16
   attention kernel's D = 128 and MLA (D, Dv) = (192, 128) instances
   must not spill. Then the
   ogb_products graph of the GNN phase,
   ``full_graph(2_449_029, 61_859_140, 100, 47, seed=0)``, built on the
   host (its seconds printed): its destinations are phase 2's ids; the
   minibatch_lg block batch, ``sampled_minibatch(232_965, 114_615_892,
   602, batch_nodes=1024, fanouts=[15, 10])`` (its 229M-entry CSR sorted
   on the card, the same arrays as numpy's; seconds printed), and
   ``molecule_batch(128)`` and ``molecule_batch(4096)``.
2. Each graph kernel against its plain PyTorch version on the card, at
   the shapes of the main path, bit for bit: ``edge_hook``'s sv2 and sv3
   at the giant+dust graph's round-1 and round-4 states, the random
   graph's round-1 state, the dense graph's first Afforest sampling
   round (``a = arange(n)``) and a 2^22-edge star whose every hook
   targets one root. ``segment_sum`` against
   its plain version at the GNN path's shapes: the ogb_products ids with
   (m, 100) and (m, 64) float32 rows (gin-tu's layers), GAT's (m, 8, 8),
   (m, 8), (m, 1, 47) and (m, 1), (m, 64) in bf16; power-law ids at
   ogb_products' size (destinations drawn with weight (rank + 1) ** -0.8,
   largest segment about 685k rows) with (m, 64) rows; a hub segment
   owning a tenth of 2^22 rows, in float32 and bf16; one segment owning
   every row; empty segments with negative and sentinel ids; and rows
   wider than the kernel's 128-column block, which it copies row by row:
   the molecule cell's graph readout, (nodes, 320) over its graph ids,
   and 129 and 1,433 (Cora's features) columns on a 2^18-row hub, each
   in float32 and bf16 and each also two calls bit-equal; and phase 15's
   shapes in float32, each also two calls bit-equal: on
   molecule_batch(4096)'s ids EGNN's (m, 1), (m, 3) and (m, 64), PNA's
   (m, 16) and (m, 32), MACE's (m, 128, 1), (m, 128, 3) and (m, 128, 5),
   the readouts (nodes, 1) and (nodes,) over its graph ids, and on
   minibatch_lg's ids SAGE's (m, 602) and (m, 64). float32
   within rtol 2e-5, bf16 within 2e-2, each with an atol of 2e-5 times
   the output's rms times sqrt(max degree): the two sum in different
   orders (the plain version with atomics). Two calls bit-equal at the
   (m, 100) shape and the hub; the row pointers the kernel writes equal
   ``torch.searchsorted`` on the ogb_products, hub and empty, negative
   and sentinel ids. ``ops/segment.py``'s ``segment_sum``,
   ``segment_mean`` and ``segment_softmax`` on sorted int64 ids with a
   negative id and ids past int32: ``[2, 0, 0, 7, 0]``, its mean, and
   the plain path's softmax, through three kernel launches. The MoE
   combines' shapes in bf16: mixtral's (16,384 x 4096), 2 rows a token,
   and deepseek-v3's (32,768 x 7168), 8 rows a token, each within 2e-2
   and two calls bit-equal.
   ``ordered_fold`` against its plain version, bit for bit: PageRank's
   degrees (also against ``np.add.at``) and first mass step on phase 12's
   graph, the mass step in both forms (generic, on ``dmp * (out[a] * w2)``
   written out; fused, the kernel gathering ``out`` and multiplying
   itself), which must also agree; two empty groups in three and one
   group of 4,096 values, each in both forms; 2^23 power-law ids over
   2^20 groups (drawn as the GNN phase's power-law ids are; also against
   ``np.add.at``, and the fused form on them against ``np.add.at``); and
   a star of 2^20 arcs into one hub against ``np.add.at``.
3. Connected components through ``connected_components(src, dst, n)``
   on a 2^22-node giant+dust graph, a 2^20-node random graph with about
   2^22 edges, and a 2^20-node random graph with about 9 * 2^20 edges,
   dense enough (m/n >= 8) for the dispatch to run the Afforest
   sampling pre-pass. Each is checked by vectorised invariants, by the
   true component count, and against the dense engine's plain PyTorch
   run: labels and rounds bit for bit, or, after sampling, which picks
   other roots, the same partition. ``edge_hook`` must have launched
   twice per round, sampling rounds included. On the dense graph the
   pre-pass's sample table, whose duplicate writes the last one wins,
   is held against numpy's in-order assignment.
4. List ranking through ``list_rank(succ)`` on a 2^23-node random list
   with 4096 splitters, checked as a permutation with
   ``rank[succ[j]] == rank[j] - 1``; ``pointer_jump`` and
   ``splitter_aggregate`` must each have launched once.
5. Times: each kernel's device time, from CUDA events around replays
   of a CUDA graph of many calls, beside its byte bound at the H100's
   3.35 TB/s, its plain version's time taken the same way, and the time
   per call when the wrapper is called from Python (the difference is
   the host's cost of a call); ``pointer_jump``'s latency floor (its
   launch and barrier steps without gathers, at p = 4096) and its step
   path's (p = 65,536: 16 dependent step launches on a one-node list),
   beside the step path's byte bound; ``edge_hook``
   summed over every call of each CC cell (recorded in one more run of
   each and replayed), beside the summed byte bound; the
   end-to-end wall time of phases 3 and 4 (median of three calls after
   a warm-up); from separate traced runs, the engine's share of each CC
   call and the RS3 walk's share of ``list_rank``; from
   ``torch.profiler`` runs, the card's idle share in each CC cell and in
   ``list_rank`` on a 2^20-node list. ``segment_sum`` at gin-tu's
   and gat-cora's shapes, the power-law case and the hub case: device
   ms, ms per Python call, plain ms, and ``torch.segment_reduce(data,
   "sum", lengths=...)`` (``library_ms``; ``index_add_`` beside it),
   both yardsticks the port never calls, with the byte bound; at
   gin-tu's layer-1 shape also its passes by device time and
   ``torch.searchsorted``'s time for the row pointers. ``ordered_fold``
   on PageRank's mass step, generic and fused (the record: the call each
   iteration makes), on the power-law ids and on the star's hub: device
   ms, ms per Python call, the plain version's ms per Python call (it
   reads the degrees to the host, so no CUDA graph holds it),
   ``torch.index_add`` on the same values (``library_ms``: it adds
   through atomics in no fixed order, so it is a yardstick, not the same
   function), the byte bound, the floor that L2's random-sector rate sets
   on the gathers, and the chain floor: the largest degree times the
   latency of one add, from ``ordered_fold_chain_floor`` (2^20 dependent
   adds in one thread).

6. ``flash_attention`` against its plain version (``attention_ref``)
   on the card within rtol = 3e-2 in bf16 and 2e-3 in float32, and an
   atol of the same fraction of the output's root mean square:
   (a) qwen3-4b's prefill shape, B=2, Hq=32, Hkv=8, S=4096, D=128,
   causal; (b) layer 0's q/k/v of the full-width model on the prefill
   tokens; (c) gemma's MQA shape (Hq=8, Hkv=1, D=256, S=1000); (d)
   phi3's MHA shape (Hq=Hkv=32, D=96, S=777), non-causal, so keys past
   a block edge must not score; (e) S=2048 with window=512; (f) float32;
   (g) S=4097 and (h) Sq=129, Sk=4096, causal; (i) Sq=1, Sk=4096,
   non-causal; (j) D=128 with window=1 and window=100; (k) MHA (Hq=Hkv=32)
   and (l) MQA (Hkv=1) at D=128; (n) a window of 2**40, past a C int;
   (m) the transposed (B, S, H, D) views that attention.py passes, whose
   output must keep q's strides and equal the call on contiguous copies
   bit for bit; a ``q`` that requires grad goes through the autograd
   Function (one forward launch, a ``grad_fn``, the bits of the same
   call under ``torch.no_grad()``, which is held to the plain version;
   phase 17 checks the backward); two calls at shape (a) bit-equal;
   every other head_dim instance in both types; rows with no live key
   (Sq > Sk + window); and, at S=32768 (the ``prefill_32k`` length, where
   the plain version's scores would take 137 GB), the first and last
   256 rows against ``attention_ref`` on those rows alone. (o) MLA's
   (D, Dv) = (192, 128) instance at deepseek-v3's prefill shape (B=1,
   H=128, S=4096, causal) on the model's layout (q, k from ``torch.cat``,
   v a strided view of the latent's expansion), heads 0-15 and 112-127
   against ``attention_ref`` on those heads (Hq = Hkv), bit-equal to the
   call on contiguous copies and to a second call; (p) MLA at a ragged
   S=1000, causal and not.
7. Prefill at full width: qwen3-4b's ``CONFIG`` in bf16 from
   ``init_params`` with a seeded CUDA generator, ``forward`` on (2, 4096)
   tokens from ``np.random.default_rng(0)``: a warm-up, then three
   timed calls (median ms, tokens/s), ``flash_attention`` launched 36
   times in the first, peak device memory, and the device idle share
   from one ``torch.profiler`` run.
   The activation's op-by-op cost against one fused ``F.silu``.
8. Prefill against decode: the logits of ``forward`` (through the
   kernel) and of ``prefill``'s loop (token by token through
   ``serve_step``, which shares no attention code with it) at every
   position of B=2, S=512: every row whose decode top-2 margin exceeds
   0.1 must have the same argmax, and no logit may differ by more than
   ``CONSISTENCY_MAX_DIFF``.
9. Serving at full width: ``ServeEngine(params, CONFIG, num_slots=4,
   max_len=512)`` on 8 requests, and ``num_slots=64, max_len=4096`` (the
   KV cache one card holds beside the weights) on 128, with prompts of
   16-128 tokens and ``max_new_tokens=32``: 2 waves, every request
   completed, 32 tokens each; decode tokens/s, steps, ms per step, peak
   memory; one request of each re-scored by ``forward`` under the
   margin rule; the idle share of a short profiled run of the wide
   engine.
10. ``flash_attention``'s times at shape (a) and at S=32768 beside
   ``scaled_dot_product_attention`` (the yardstick; the port never
   calls it) and its FLOP bound at 989 TFLOP/s: share of the bound and
   TFLOP/s; then both at the lengths of ``ATTN_SWEEP``.
11. GNN inference, after the LM has freed its memory: gin-tu and
   gat-cora at ``config_for("ogb_products")`` (full width, float32,
   random from a seeded CUDA generator) on the ogb_products graph: a
   warm-up, then three timed ``forward`` calls (median ms, edges/s =
   layers * m / t, peak memory), exactly 5 and 4 ``segment_sum``
   launches in the first, and the logits against an independent
   forward (``gnn_by_index_add``) within rtol = 2e-3 and an atol of
   2e-3 times the smaller of 1 and the logits' rms, with equal argmaxes
   wherever the top-2 margin exceeds 1e-2; the idle share and top
   device kernels of each from one ``torch.profiler`` run. Then gin-tu
   with graph readout on ``molecule_batch(128)``: 6 launches, the same
   check.
12. Graph analytics, on the CC random cell's graph (2^20 nodes, about
   2^22 edges) with float32 weights uniform in [0, 1) from
   ``default_rng(3)``. SSSP through ``shortest_paths`` from source 0 and
   from a batch of four: the frontier engine equal to the dense one bit
   for bit (distances, parents, rounds), each batched row equal to its
   solo run, the fixpoint on every arc, every reachable node's parent
   arc tight, and the distances within 1e-5 relative of scipy's float64
   Dijkstra. PageRank through ``pagerank`` to tol = 1e-6: the dense
   engine at the same iterations bit-equal, 5 iterations bit-equal to
   the numpy ``serial_pagerank``, ``ordered_fold`` launched once for the
   degrees and once per iteration; the same checks on a power-law graph
   of 2^20 nodes and 2^22 edges (uniform sources, destinations drawn
   with weight (rank + 1) ** -0.8), with its wall time and largest
   degree. Tree analytics through
   ``tree_analytics`` on ``benchmarks/tree_ops.py``'s families: a path
   and ``random_tree(2^22, seed=1)``, and ``random_tree_forest(2^20,
   2^20 // 30, seed=2)`` (cut from 2^22: its host build is a Python loop
   over the trees; its seconds printed). Both rank engines equal, the
   tree invariants, ``edge_hook`` twice a CC round, one
   ``splitter_aggregate``, and ``pointer_jump`` once at p <= 4096 or
   once a step above (the forest's p takes the step path); then each
   stage timed (median of three under 5 s, else one call); and a 2^16-node
   forest against the port's ``serial_tree_reference``. The SSSP and
   PageRank calls are timed as the median of three after a warm-up, and
   so is the dense PageRank engine at ``pagerank_iter_bound()``
   iterations (98 ``ordered_fold`` launches and one for the degrees);
   ``torch.profiler`` gives the idle share of one ``pagerank`` call and
   one path ``tree_analytics`` call.
13. Graph serving through ``GraphServeEngine`` on the card: a backlog of
   ``graph_request_stream(4096, seed=11)`` requests (6-40 nodes each) of
   each kind -- cc and forest (random graphs), analytics (random trees)
   with ``rank_engine="auto"`` (wylie) and ``"splitter"``, sssp and
   pagerank (random graphs) -- served at the reference's default budget
   (16 requests, 4,096 nodes, 16,384 edges a wave) and at a wide one
   (1,024 requests, 32,768 nodes, 65,536 edges): requests/s, waves, the
   median wave's ms (each wave ends in its outputs' read), hand-kernel
   launches a wave and peak memory. ``edge_hook`` twice a CC round of
   every cc-chain wave, ``ordered_fold`` 1 + ``pagerank_iters`` times a
   pagerank wave, ``pointer_jump`` and one ``splitter_aggregate`` a wave
   in the splitter runs and neither in the wylie runs. The first 64
   requests of each stream, served solo on the card and batched on the
   CPU, bit-equal to both budgets' results; their component counts
   against numpy propagation, forests of n - components edges, the tree
   invariants, SSSP against scipy's Dijkstra, PageRank against
   ``serial_pagerank`` bit for bit. The idle share (and the pad hub's
   slots at node 0) of one wide pagerank wave and one wide analytics
   wave from ``torch.profiler``. ``benchmarks/serve_chaos.py``'s streams
   and fault plans at their ``BENCH_smoke.json`` sizes give exactly that
   file's containment counters on the card.
14. The sharded graph engine (``repro_torch.distributed.graph``) over
   NCCL at world size 1 (one rank, an in-memory store, no network;
   the same collectives as P ranks, each with one participant):
   ``benchmarks/multidev_scaling.py``'s ``*_dev1`` rows of
   ``BENCH_smoke.json`` at n = 100, character for character; then each
   CC cell of phase 3, deduplicated once on the host and passed with
   ``dedup=False``, through ``connected_components(..., mesh=mesh)``
   (the sharded frontier engine, sparse exchange) and ``engine="dense"``
   with the dense and the sparse exchange: labels and rounds equal the
   single-device dense engine's on the card (the sharded engines run no
   Afforest pre-pass), ``edge_hook`` twice a round, each call's words
   per round, its wall time (median of three after a warm-up) beside
   the single-device engine's; the giant+dust cell with
   ``record_hooks=True``, its forest equal; the share of the card's busy
   time in NCCL kernels from one ``torch.profiler`` run; phase 4's list
   through ``list_rank(succ, mesh=mesh)``, its ranks equal, one
   ``pointer_jump`` and one ``splitter_aggregate`` launch; and
   ``tree_analytics(..., mesh=mesh)`` on phase 12's molecule-batch
   forest, equal to the single-device splitter run. The process group
   is destroyed on the way out.
15. The rest of GNN and RecSys inference at full width, float32.
   ``segment_sum`` at phase 2's new shapes: device ms, plain ms,
   ``segment_reduce`` ms and the byte bound. Then each cell, a warm-up
   and three timed forwards (median ms; edges/s = layers * m / t, or
   rows/s), ``segment_sum`` launches counted from 0 in the first, peak
   memory, and the first call's output against the same forward with
   every segment sum an ``index_add_`` (which launches no kernel):
   GCN and GraphSAGE (2 layers, 64 wide) on the ogb_products graph and
   SAGE on minibatch_lg, logits within rtol 2e-3 and argmaxes as phase
   11; PNA (2 layers, 32 wide) on both molecule batches, logits within
   rtol 2e-3;
   EGNN (4 x 64) and MACE (2 layers, 128 channels, l_max 2, correlation
   3, 64 species) on both, readout, positions and energies within rtol
   2e-3; on molecule_batch(4096) a fixed rotation of the positions leaves
   EGNN's readout and MACE's energies within 1e-3 of their largest and
   rotates EGNN's positions (MACE on the graph without its self-loops,
   whose Y_l of a zero vector does not turn; the whole graph's change is
   printed). EGNN's coordinate MLP's last layer is scaled by 1e-3 after
   ``init_params``, as the EGNN authors initialise it. The ogb and
   molecule(4096) cells are profiled as phase 11's. xDeepFM at full
   width (39 fields x 10^6 rows, embed 10, CIN 200-200-200, MLP
   400-400): ``serve_step`` on 512 and 262,144 rows of ``recsys_batch``
   (the chunked CIN's logits against the one-shot einsum at 512 rows;
   the bulk batch's first 512 scores against the 512-row call), and
   ``serve_retrieval`` of one row over 10^6 candidates, top 100, against
   float64 scores; then ``embedding_bag`` sum and mean over its table
   (one launch each) against ``F.embedding_bag``, and both timed.
16. MoE, MLA and the MTP head at published widths, depth cut (printed
   with each line): first the kernels' times at the new shapes --
   ``flash_attention`` at MLA's prefill shape beside its plain version,
   SDPA where a backend takes Dv != D (named), its FLOP bound (2 (D +
   Dv) per live pair at 989 TFLOP/s) and the ``torch.cat`` that writes
   the shared rope key into every head; at mixtral's windowed prefill
   (S=8192, w=4096); ``segment_sum`` at both combines beside
   ``segment_reduce`` and the byte bound; and the sorted-vs-unsorted
   dispatch A/B at deepseek-v3's T=4096, k=8, E=256 (the same buffer;
   printed, no claim). Then mixtral-8x7b (4 of 32 layers, 12.1 GB of
   weights) and deepseek-v3 (its 3 dense layers, 1 of 58 MoE layers and
   the MTP layer, 31.4 GB), each from ``init_params`` with a seeded CUDA
   generator and freed before the next: every MoE layer against a
   float32 per-expert oracle on its input in a forward of the prefill
   tokens (each token's row within 3e-2 in norm); ``forward`` on
   ``lm_batch`` tokens at B=1, S=8192 (twice mixtral's window) and
   S=4096: a warm-up, then three timed calls (median ms, tokens/s),
   ``flash_attention`` once a layer and ``segment_sum`` once an MoE layer
   in the first, peak memory, the idle share of one profiled call;
   deepseek-v3's ``_mtp_logits`` once (one launch, finite logits);
   prefill against decode at every position of a 64-token prefix by
   phase 8's margin rule, with a capacity of every token (capacity
   factor max(8, E/k)) so neither drops one; and ``ServeEngine`` with 8
   slots of 8192 rows (mixtral's 4096-row ring) and of 4096 rows on 16
   ``lm_batch`` prompts of 16-128 tokens at the published capacity
   factor 1.25, 32 new tokens each, as phase 9 (no re-scoring: a decode
   step's tokens compete for experts as a prefill's do not).
17. Single-device training. (a) ``flash_attention``'s backward kernel
   (``csrc/flash_attention_bwd.cu``) against ``attention_vjp_ref`` at
   ``ATTN_BWD_CASES``: qwen3-4b's training shape (B=1, Hq=32, Hkv=8,
   S=4096, D=128, causal), mixtral's window (w=4096, S=8192, Hq=4,
   Hkv=1), MLA's (192, 128), float32, a non-causal ragged S=777, rows
   with no live key, and every head dim in both dtypes; float32 within
   rtol = atol = 2e-3 (atol times the rms), bf16 within 3e-2 in norm per
   gradient, the elementwise worst printed beside; at the training shape
   two calls bit-equal and the autograd Function's gradients equal to the
   direct call's; then its time there beside its plain version, SDPA's
   backward (the yardstick) and the five-product FLOP bound. (b)
   qwen3-4b at full width (``TRAIN_LM_LAYERS`` of 36 layers, bf16, float32
   moments, ``remat=True``, B=1, S=4096 ``lm_batch`` tokens): on a 2-layer
   cut every gradient on the kernel route within 3e-2 in norm of the
   ``impl="torch"`` route, and a ``num_microbatches=2`` step at B=2 equal
   (1e-3 in norm) to the mean of its halves' float32 gradients; then
   ``train()`` for 6 AdamW steps on one repeated batch (lr 1e-3, 2
   warm-up steps): the loss falls by more than 0.5, two forward and one
   backward attention launches a layer a step; step ms, tokens/s, peak
   memory, and one profiled step's idle share and the backward kernel's
   share of busy time. (c) gin-tu at ``config_for("ogb_products")`` on
   phase 11's graph: the first step's gradients within 2e-3 in norm of
   the autograd of ``gnn_by_index_add``; ``train()`` for 3 steps (one
   ``segment_sum`` launch a layer a step), step ms, edges/s, peak
   memory. (d) the checkpoint ``train()`` wrote at its last step
   restored, saved again from the card and restored: bit-equal.
18. Sharded training over NCCL at world size 1 (a one-rank group; every
   collective runs with one participant), on ``make_test_mesh((1, 1))``:
   (a) deepseek-v3 at full width, its 3 dense layers, 1 MoE layer (all
   256 experts) and the MTP layer, bf16, ``remat``, B=1, S=2048: one
   ``loss_fn(mesh=)`` and its backward with ``reduce_gradients`` (the MoE
   layer on the expert-TP schedule, which a one-rank mesh picks, with
   the meshless capacity) against the meshless route: the loss and
   every gradient bit-equal, except any leaf whose meshless gradient
   differs between two meshless runs (named, and held at 3e-2 in norm);
   the meshless gradients wait on the host, as the card holds one
   gradient set beside the 31.3 GB of weights. Then an AdamW step (bf16
   moments) on the sharded parameters but the expert bank: the moments
   of every leaf (twice the weights' bytes) do not fit beside the weights
   and gradients; the line prints both figures. (b)
   mixtral-8x7b's 4-layer cut at full width: ``forward(mesh=)`` logits at
   B=1, S=4096 and four ``serve_step(mesh=)`` decode steps bit-equal to
   the meshless ones. (c) gin-tu on ogb_products: one edge-parallel step
   (``psum_axes=("data",)``) bit-equal to the meshless step, both with
   ``torch.use_deterministic_algorithms(True)`` (the gathers' gradients
   otherwise add by atomics in no fixed order). (d)
   ``pipeline_apply`` on a 1-stage ``("pod",)`` mesh and
   ``sharded_row_gather``, bit-equal to the sequential loop (microbatch
   by microbatch) and to ``F.embedding``, their gradients within
   ``assert_close``'s defaults; and the psum schedule's expert products
   (bf16 GEMMs with float32 output) against the widened products at
   deepseek-v3's widths. Each part's time beside the
   meshless time, and the phase's launches of ``flash_attention``
   (forward and backward) and ``segment_sum``, which must be nonzero.
19. The last modules. (a) The dry-run CLI (``python -m
   repro_torch.launch.dryrun``) on qwen3-4b ``train_4k`` (16x16),
   deepseek-v3-671b ``decode_32k`` (2x16x16) and gin-tu
   ``ogb_products`` (16x16), one process a cell (each its own fake
   process group) started together from one shell subprocess, on the
   host's cores while (b)-(d) run on the card: each record ``ok`` and
   printed (analytic H100 figures, not measurements). (b) Three built
   specs (``arch.build(shape, mesh)``) on ``make_test_mesh((1, 1))``
   over NCCL, run once on arguments made on the card (the model's
   seeded init, zero moments, a seeded batch to the spec's shapes with
   ids in range; gin-tu on phase 11's ogb_products graph): gin-tu
   ``ogb_products``, MACE ``molecule`` and xDeepFM ``train_batch``
   (65,536 rows): the loss finite, ``segment_sum`` launched by the GNNs,
   the step's wall ms, the argument bytes on the card against the dry
   run's ``argument_size_in_bytes`` for the cell on (1, 1) (the
   allocator's requested bytes equal, ``memory_allocated`` above them
   by no more than its rounding), and the parameters moved as the
   meshless ``make_train_step`` moves them from the same arguments: the
   loss within ``BUILT_TOL`` and each parameter's update within
   ``BUILT_TOL`` in norm. (c) The five examples
   (``examples/torch_*.py``) in this process through ``main(argv)`` at
   the reference's default arguments, each checking itself, with their
   hand-kernel launches printed: the quickstart's ``edge_hook``,
   ``pointer_jump`` and ``splitter_aggregate``, train_lm's
   ``flash_attention`` and its backward's wmma design (float32, D = 32),
   gnn_cora's ``segment_sum`` must be above 0 (serve_lm decodes token by
   token, which runs no hand kernel; xDeepFM has none). (d) One traced
   quickstart-sized CC call exported with ``export_chrome`` and
   summarised by ``summarize --require cc.frontier``.
   The script's total seconds are printed at the end, and each phase's
   start.

Every profile prints the host's launch calls beside the device records
it kept, and is used only if it kept one for each (``device_share``).

Every line but the last is a report. The line before the last is one
JSON object with a record per kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, the script exits nonzero and prints no
result. It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, the same sheet

# The main path's sizes.
CC_GIANT_N = 4_194_304
CC_RANDOM_N = 1_048_576
CC_RANDOM_DENSITY = 8 / (CC_RANDOM_N - 1)  # m = 4n edges, m/n = 4
CC_DENSE_N = 1_048_576
CC_DENSE_DENSITY = 18 / (CC_DENSE_N - 1)  # m = 9n edges: auto-Afforest on
LIST_N = 8_388_608
SPLITTERS = 4096
POINTER_JUMP_BIG_P = 65_536  # above the one-launch limit: the step path
PROFILE_LIST_N = 1_048_576  # list size of the profiled list_rank call
STAR_M = 1 << 22  # edges of phase 2's star, every hook into one root

KERNELS = {
    "edge_hook.sv2": ("edge_hook", "src/repro/kernels/edge_hook/edge_hook.py:27"),
    "edge_hook.sv3": ("edge_hook", "src/repro/kernels/edge_hook/edge_hook.py:27"),
    "pointer_jump": (
        "pointer_jump", "src/repro/kernels/pointer_jump/pointer_jump.py:22"),
    "splitter_aggregate": (
        "splitter_aggregate",
        "src/repro/kernels/splitter_aggregate/splitter_aggregate.py:19"),
    "flash_attention": (
        "flash_attention",
        "src/repro/kernels/flash_attention/flash_attention.py:24"),
    "segment_sum": (
        "segment_sum", "src/repro/kernels/segment_sum/segment_sum.py:24"),
}

# The GNN phases' sizes: GNN_SHAPES["ogb_products"] at full width.
GNN_SHAPE = "ogb_products"
GNN_N, GNN_M, GNN_D, GNN_CLASSES = 2_449_029, 61_859_140, 100, 47
GNN_ARCHS = (("gin-tu", 5), ("gat-cora", 4))  # segment_sum launches a forward
MOLECULE_BATCH, MOLECULE_LAUNCHES = 128, 6  # gin-tu with graph readout
HUB_M, HUB_N = 1 << 22, 1 << 18  # one segment owns HUB_M // 10 rows
WIDE_HUB_M, WIDE_HUB_N = 1 << 18, 1 << 14  # the hub of phase 2's wide rows
WIDE_COLS = (129, 1433)  # one column past a column block; Cora's features
POWER_LAW = 0.8  # destinations drawn with weight (rank + 1) ** -POWER_LAW
SEGSUM_RTOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
SEGSUM_ATOL = 2e-5  # times the output's rms times sqrt(max degree)
GNN_TOL = 2e-3  # rtol of the logits against gnn_by_index_add; atol x min(1, rms)
GNN_MARGIN = 1e-2  # top-2 gap above which two argmaxes must agree

# Phase 12's sizes. SSSP and PageRank run on the CC random cell's graph.
SSSP_WEIGHT_SEED = 3  # float32 weights uniform in [0, 1) from default_rng(3)
SSSP_BATCH = (0, 262_144, 524_288, 786_432)  # the batch of four sources
SSSP_RTOL = 1e-5  # float32 distances against scipy's float64 Dijkstra
PAGERANK_ORACLE_ITERS = 5  # iterations held to the numpy oracle
TREE_N = 4_194_304  # the path and one-tree families
# The molecule-batch forest, cut from 2^22 nodes: its host build runs one
# random_tree per tree (n / 30 of them) in a Python loop.
TREE_MOLECULE_N = 1_048_576
TREE_ORACLE_N = 65_536  # forest held to serial_tree_reference
STAR_LEAVES = 1 << 20  # phase 2's ordered_fold star: every arc into one hub
PAGERANK_M2 = 1 << 23  # arcs of phase 2's power-law ids and phase 12's power-law graph
# Random 4-byte gathers a second from a 16 MB table, which L2 holds: the
# probe of tools/edge_hook_ab.py on an H100 80GB HBM3 at 700 W (PERF.md).
L2_SECTORS_PER_S = 1.36e11

# Phase 13's sizes: graph serving. Each stream is a backlog of
# SERVE_GRAPH_REQUESTS requests of 6-40 nodes, served at the reference's
# default budget and at a wide one; the first SERVE_GRAPH_CHECKED requests
# of each are also served solo on the card and batched on the CPU.
SERVE_GRAPH_REQUESTS = 4096
SERVE_GRAPH_CHECKED = 64
SERVE_GRAPH_SEED = 11
SERVE_GRAPH_STREAMS = (  # (label, kind, family, engine knobs)
    ("cc", "cc", "random", {}),
    ("forest", "forest", "random", {}),
    ("analytics-wylie", "analytics", "tree", {"rank_engine": "auto"}),
    ("analytics-splitter", "analytics", "tree", {"rank_engine": "splitter"}),
    ("sssp", "sssp", "random", {}),
    ("pagerank", "pagerank", "random", {}),
)
SERVE_GRAPH_BUDGETS = (
    ("default", {}),  # 16 requests, 4,096 nodes, 16,384 edges a wave
    ("wide", {"max_requests": 1024, "max_nodes": 32768, "max_edges": 65536}),
)

# Phase 15's sizes: the rest of GNN and RecSys inference at full width.
# molecule_batch(MOLECULE_BIG) has n = 122,880 nodes and m = 262,144 edges.
MOLECULE_BIG = 4096
MINIBATCH_LG = dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                    batch_nodes=1024, fanouts=[15, 10], num_classes=41)
XDEEPFM_SERVE = (("serve_p99", 512), ("serve_bulk", 262_144))
RETRIEVAL_TOP_K = 100
ROTATION_RTOL = 1e-3  # energies, readouts and positions under a fixed rotation
# EGNN's coordinate MLP's last layer is scaled by this after init_params, as
# the EGNN authors initialise it (xavier, gain 0.001): at the reference's He
# scale the full-width model's coordinates overflow float32 by layer 4 on
# molecule_batch's positions (a 10 A box).
EGNN_COORD_GAIN = 1e-3

# Phase 14's sizes: the sharded engine at phases 3-4's sizes, and the
# multidev_scaling rows of BENCH_smoke.json at their smoke size.
SHARDED_DEV1_N = 100

# Phase 16's sizes: mixtral-8x7b and deepseek-v3 at their published widths,
# depth cut to what one card holds with the phase's activations: (arch,
# layers kept, prefill S at B = 1, serving max_len). mixtral keeps 4 of 32
# layers (12.1 GB of bf16 weights), its prefill twice its 4,096 window;
# deepseek-v3 keeps its 3 dense layers, 1 of its 58 MoE layers and the MTP
# layer (31.4 GB).
MOE_CELLS = (("mixtral-8x7b", 4, 8192, 8192), ("deepseek-v3-671b", 4, 4096, 4096))
MOE_SERVE_SLOTS, MOE_SERVE_REQUESTS = 8, 16
MOE_CONSISTENCY_S = 64  # prefix held to the decode at every position
MLA_HEADS, MLA_S, MLA_RAGGED_S = 128, 4096, 1000  # deepseek-v3's prefill attention
MLA_CHECK_HEADS = 16  # heads of each end held to attention_ref at S = 4096
# (T, top_k, d) of each MoE combine: T * top_k rows, top_k a token.
MOE_COMBINES = (("mixtral-8x7b", 8192, 2, 4096), ("deepseek-v3-671b", 4096, 8, 7168))
# bf16 MoE layer against the float32 oracle: each token's output row within
# MOE_TOL of the oracle's row in norm. A wrong expert, gate, token or drop
# moves a row by about its own size; bf16's roundings move it by ~0.5%, with
# a heavy tail elementwise (a few of 33.5M elements past 3e-2 x rms, printed).
MOE_TOL = 3e-2

# The LM phases' sizes.
LM_ARCH = "qwen3-4b"
PREFILL_B, PREFILL_S = 2, 4096
CONSISTENCY_S = 512
SERVE_NEW = 32  # tokens each request generates
# (slots, max_len, requests, profiled): the small check, and the cell at
# the width one card holds: 64 slots of 4096 rows of qwen3-4b KV cache
# are 38.7 GB beside the 8.8 GB of weights (128 slots would need 77 GB).
SERVE_CELLS = ((4, 512, 8, False), (64, 4096, 128, True))
LONG_S = 32_768  # prefill_32k's sequence length
MARGIN = 0.1  # top-2 logit gap above which two argmaxes must agree
# Largest |forward - decode| over every logit of phase 8: about twice
# the largest reading of passing runs on an H100 (0.129 over all 1,024
# positions; 0.094 at the last ones).
CONSISTENCY_MAX_DIFF = 0.25
ATTN_TOL = {"torch.bfloat16": 3e-2, "torch.float32": 2e-3}
# The bf16 kernel's instances that must not spill: D = 128 (qwen3's and
# mixtral's prefill) and MLA's (D, Dv) = (192, 128) (deepseek-v3's).
ATTN_ENTRIES = {"D=128": "attn_tc_kernelILi128ELi128EE",
                "MLA D=192 Dv=128": "attn_tc_kernelILi192ELi128EE"}
# The backward's wgmma instances (csrc/flash_attention_bwd.cu), each
# printed; those that must not spill: D = 128 (qwen3-4b's training).
ATTN_BWD_ENTRIES = {"pass 1 DP=128": "attn_bwd_dq_tcILi128EE",
                    "pass 2 DP=128": "attn_bwd_dkdv_tcILi128EE",
                    "pass 1 DP=64": "attn_bwd_dq_tcILi64EE",
                    "pass 2 DP=64": "attn_bwd_dkdv_tcILi64EE"}
ATTN_BWD_NO_SPILL = ("pass 1 DP=128", "pass 2 DP=128")
# The forward's log-sum-exp against attention_lse_ref's, absolute, on rows
# with a live key (rows without one must be +inf in both). The backward's
# P is exp(s - lse), so an error e in lse is a relative error e in P: these
# sit well below P's bf16 rounding (2^-9) and float32's 2e-3.
ATTN_LSE_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# The forward with lse written against the forward without, at shape (a):
# at most this much slower (the same call in turns within one run).
ATTN_LSE_SLOWDOWN = 1.02
ATTN_LSE_ROUNDS = 6
ATTN_LSE_ITERS = 200
# (B, S, causal) of phase 10's sweep at Hq=32, Hkv=8, D=128: B * S tokens
# near shape (a)'s, from short rows to long.
ATTN_SWEEP = ((8, 1024, True), (4, 2048, True), (2, 4096, False), (1, 8192, True),
              (1, 16384, True))


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` called from Python, by CUDA
    events, after a warm-up. A call shorter than the host's cost of
    issuing it is timed at the host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: CUDA events around
    ``replays`` replays of one CUDA graph that holds ``calls`` calls, so
    no host work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def wall_s(fn):
    """``(result, seconds)`` of ``fn()`` by the host clock, ending in a
    device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn) -> dict[str, float]:
    """Run ``fn`` once with the port's tracer on; returns the total
    milliseconds of each span name."""
    from repro_torch.obs import trace

    trace.configure(trace="on")
    trace.reset()
    try:
        fn()
    finally:
        trace.configure(trace="off")
    totals: dict[str, float] = {}
    for ev in trace.chrome_trace()["traceEvents"]:
        if ev["ph"] == "X":
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return totals


E2E_SAMPLES = 3  # timed calls per end-to-end cell; the first is checked


# Host calls that each put one record on the card's timeline.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
# On the H100 a profile loses device records of the first launches after
# it starts (from one to a few hundred; never later ones), more often the
# longer the process has run. Each profile first launches this many
# throwaway kernels, outside the profiled call, to take those losses.
PROFILE_WARMUP_LAUNCHES = 1024
PROFILE_ATTEMPTS = 3


def device_share(fn=None, top: int = 0, prepare=None):
    """Run ``fn`` once under ``torch.profiler``; returns its wall
    milliseconds, the milliseconds the card was busy (the union of the
    intervals of its kernels, copies and sets, so nothing is counted
    twice), the number of those device events, the ``top`` device event
    names by total milliseconds, and the device idle share. The profiler
    slows the host, so the idle share is an upper bound.

    Only the launch calls made inside ``fn`` (a ``record_function``
    span) and their device records count. A profile is used only if it
    holds a record for each of those calls; one that lost records would
    count their time as idle. It is taken again, up to PROFILE_ATTEMPTS
    times, and the check fails if none is whole. ``prepare``, where
    given, is called before each attempt, outside the profile, and
    returns the call to profile (for a call that cannot run twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if prepare is not None:
            fn = None
            fn = prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_WARMUP_LAUNCHES):
                scratch.add_(1)
            torch.cuda.synchronize()
            with record_function("chip_smoke.profiled"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        events = list(prof.events())
        window = next(ev.time_range for ev in events
                      if ev.name == "chip_smoke.profiled"
                      and ev.device_type == DeviceType.CPU)
        launches = {ev.id for ev in events
                    if ev.device_type != DeviceType.CUDA and ev.name in LAUNCH_CALLS
                    and window.start <= ev.time_range.start <= window.end}
        device = [ev for ev in events
                  if ev.device_type == DeviceType.CUDA and ev.id in launches
                  and ev.name != "chip_smoke.profiled"]
        warm = sum(1 for ev in events if ev.device_type == DeviceType.CUDA
                   and ev.time_range.start < window.start)
        print(f"profiler attempt {attempt}: launch_calls={len(launches)} "
              f"device_events={len(device)} warmup_records={warm} of "
              f"{PROFILE_WARMUP_LAUNCHES}")
        if launches and len({ev.id for ev in device}) == len(launches):
            break
    check(launches and len({ev.id for ev in device}) == len(launches),
          f"a profile holds a device record for each of its "
          f"{len(launches)} launch calls ({len(device)} held)")
    spans, by_name = [], {}
    for ev in device:
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = (by_name.get(ev.name, 0.0)
                            + (ev.time_range.end - ev.time_range.start) / 1e3)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return wall_ms, busy_us / 1e3, len(spans), ranked, 1 - busy_us / 1e3 / wall_ms


def median(xs):
    return sorted(xs)[len(xs) // 2]


def components_by_propagation(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """The component count by numpy min-label propagation with pointer
    jumping, independent of the code under test: a fixpoint has equal
    labels across every edge, and each label is the least id of its
    component."""
    u, v = src.astype(np.int64), dst.astype(np.int64)
    lab = np.arange(n, dtype=np.int64)
    while True:
        low = np.minimum(lab[u], lab[v])
        new = lab.copy()
        np.minimum.at(new, u, low)
        np.minimum.at(new, v, low)
        new = new[new]
        if np.array_equal(new, lab):
            return int(np.count_nonzero(lab == np.arange(n)))
        lab = new


def same_partition(x, y) -> bool:
    """Whether two label tensors cut the nodes into the same sets: each
    label of ``x`` pairs with exactly one label of ``y``."""
    import torch

    pairs = torch.unique(x.to(torch.int64) * (y.numel() + 1) + y.to(torch.int64))
    return pairs.numel() == torch.unique(x).numel() == torch.unique(y).numel()


def check_sample_table(dev, src, dst, n, k):
    """The Afforest pre-pass's (n, k) sample table built on the card,
    where the order of duplicate writes is undefined, against numpy's
    in-order fancy assignment, in which the last write wins: the
    reference's rule."""
    import torch

    from repro_torch.core.components import dedup_edges, oriented_edges
    from repro_torch.core.frontier import _build_samples

    a, b = oriented_edges(*dedup_edges(src, dst), n, device=dev)
    m2 = a.shape[0]
    perm = np.random.default_rng(0).permutation(m2)
    got = _build_samples(a, b, torch.from_numpy(perm).to(dev), n=n, k=k)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    want = np.full(n * k, -1, dtype=np.int64)
    want[a_np[perm].astype(np.int64) * k + np.arange(m2) % k] = b_np[perm]
    filled = int(np.count_nonzero(want >= 0))
    err = max_abs_err(got.reshape(-1).cpu(), torch.from_numpy(want))
    print(f"afforest sample table n={n} k={k} m2={m2}: filled={filled} "
          f"max_abs_err={err}")
    check(err == 0, "the card's sample table keeps the last write")


def max_abs_err(x, y) -> int:
    """Largest |x - y| over two integer (or bool) tensors."""
    import torch

    if x.shape != y.shape:
        raise RuntimeError(f"shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def hook_states(a, b, n, dev):
    """Two SV round states of the graph (a, b) as the hook phases see
    them: the first round's, and the fourth's after three plain rounds.
    Each is ``(D1, D, Q, s)``: short-cut labels, labels before it, the
    stamps after SV1b, and the round number."""
    import torch

    from repro_torch.core.components import sv_round_fns
    from repro_torch.kernels.edge_hook.ref import drop_scatter_fill

    D = torch.arange(n, dtype=torch.int32, device=dev)
    Q = torch.zeros(n, dtype=torch.int32, device=dev)
    states = [(D[D], D, Q, 1)]
    body = sv_round_fns(a, b, n, hook_impl="torch")
    s, hooks = 1, None
    for _ in range(3):
        D, Q, hooks, s, _changed = body((D, Q, hooks, s, True))
    D1 = D[D]
    states.append((D1, D, drop_scatter_fill(Q, torch.where(D1 != D, D1, n), s), s))
    return states


def star_state(dev, m: int = STAR_M):
    """A star of ``m`` edges from node ``m`` to the leaves, leaves in
    descending order, with identity labels and zero stamps at round 1:
    every hook of both phases targets node ``m``."""
    import torch

    b = torch.arange(m - 1, -1, -1, dtype=torch.int32, device=dev)
    a = torch.full_like(b, m)
    D = torch.arange(m + 1, dtype=torch.int32, device=dev)
    return a, b, (D, D, torch.zeros_like(D), 1)


def random_hook_state(dev, n: int, m2: int, seed: int):
    """Random edges, labels (a third of the nodes roots), previous
    labels (equal at about half the nodes) and stamps in [0, 6) at round
    s = 3, so some stamps lie above s: a state SV never reaches, which
    the kernel must still compute as its plain version does."""
    import torch

    r = np.random.default_rng(seed)
    labels = np.where(r.random(n) < 0.3, np.arange(n), r.integers(0, n, n))  # roots
    prev = np.where(r.random(n) < 0.5, labels, r.integers(0, n, n))
    a, b, labels, prev, stamps = (
        torch.from_numpy(x.astype(np.int32)).to(dev)
        for x in (r.integers(0, n, m2), r.integers(0, n, m2), labels, prev,
                  r.integers(0, 6, n)))
    return a, b, (labels, prev, stamps, 3)


def sampling_state(dev, src, dst, n):
    """The first Afforest sampling round's edges ``(arange(n),
    neighbour)`` of a graph, as ``core/frontier.py`` builds them, and
    its round-1 state."""
    import torch

    from repro_torch.core import AUTO_SAMPLE_ROUNDS
    from repro_torch.core.components import dedup_edges, oriented_edges
    from repro_torch.core.frontier import _build_samples

    a, b = oriented_edges(*dedup_edges(src, dst), n, device=dev)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(a.shape[0])).to(dev)
    neigh = _build_samples(a, b, perm, n=n, k=AUTO_SAMPLE_ROUNDS)[:, 0]
    sa = torch.arange(n, dtype=torch.int32, device=dev)
    sb = torch.where(neigh >= 0, neigh, sa).to(torch.int32)
    return sa, sb, hook_states(sa, sb, n, dev)[0]


def check_hook_state(name, a, b, state, kernel_impl, errs, sv3_from=None) -> tuple:
    """sv2 and then sv3 of one round state, the kernel against its plain
    version bit for bit; sv3 runs on sv2's output, or on ``sv3_from``
    (labels, stamps) where given. Returns ``(D2, Q2, D3)``: sv3's input
    labels and stamps and its output labels."""
    from repro_torch.kernels.edge_hook.ops import edge_hook

    D1, D, Q, s = state
    got = edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2", impl=kernel_impl)
    want = edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2", impl="torch")
    err2 = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    D2, Q2 = want if sv3_from is None else sv3_from
    got = edge_hook(a, b, D2, Q2, s, mode="sv3", impl=kernel_impl)
    want = edge_hook(a, b, D2, Q2, s, mode="sv3", impl="torch")
    err3 = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    check(bool((want[1] == (D2[a] != D2[b])).all()), "sv3 mask is D2[a] != D2[b]")
    hooked3 = int((want[0] != D2).sum())
    print(f"edge_hook {name}: m2={a.shape[0]} n={D1.shape[0]} s={s} "
          f"sv2 max_abs_err={err2} sv3 max_abs_err={err3} "
          f"sv3 slots hooked={hooked3}")
    errs["edge_hook.sv2"] = max(errs.get("edge_hook.sv2", 0), err2)
    errs["edge_hook.sv3"] = max(errs.get("edge_hook.sv3", 0), err3)
    return D2, Q2, want[0]


def phase_kernels(dev, graphs, list_n, splitters, big_p, kernel_impl):
    """Phase 2: every kernel against its plain version at the main
    path's shapes. Returns ``{name: max_abs_err}`` and the inputs phase
    5 times."""
    import torch

    from repro_torch.core.components import dedup_edges, oriented_edges
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.edge_hook.ops import edge_hook
    from repro_torch.kernels.pointer_jump.ops import pointer_jump
    from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate
    from repro_torch.ops.kiss import random_linked_list

    errs: dict[str, int] = {}
    cells = {name: (edges, n) for name, edges, n in graphs}
    edges, n = cells["giant_dust"]
    a, b = oriented_edges(*dedup_edges(edges[:, 0], edges[:, 1]), n, device=dev)
    for k, state in enumerate(hook_states(a, b, n, dev)):
        D2, Q2, _ = check_hook_state(f"giant_dust round-{state[3]} state", a, b,
                                     state, kernel_impl, errs)
        if k == 0:
            D1, D, Q, s = state
            hook_inputs = (a, b, D1, D, Q, D2, Q2, s, n)
    edges, n = cells["random"]
    ra, rb = oriented_edges(*dedup_edges(edges[:, 0], edges[:, 1]), n, device=dev)
    check_hook_state("random round-1 state", ra, rb, hook_states(ra, rb, n, dev)[0],
                     kernel_impl, errs)
    del ra, rb
    edges, n = cells["random_dense"]
    sa, sb, state = sampling_state(dev, edges[:, 0], edges[:, 1], n)
    check_hook_state("random_dense sampling round (a = arange(n))", sa, sb, state,
                     kernel_impl, errs)
    del sa, sb, state
    # Odd sizes (tails of the node and edge passes), both paths.
    for n_r, m_r in ((1001, 777), (1001, 4001)):
        ra, rb, state = random_hook_state(dev, n_r, m_r, n_r + m_r)
        check_hook_state(f"random labels and stamps n={n_r}", ra, rb, state,
                         kernel_impl, errs, sv3_from=(state[0], state[2]))
    # sv3 on the round-1 state too, where the root is stagnant: every
    # hook of both phases targets node STAR_M.
    sa, sb, state = star_state(dev)
    _, _, D3 = check_hook_state(f"star of {STAR_M} edges into one root", sa, sb,
                                state, kernel_impl, errs, sv3_from=state[1:3])
    check(int(D3[STAR_M]) == 0 and int((D3 != state[0]).sum()) == 1,
          "the star's sv3 hooks its one root onto leaf 0")
    del sa, sb, state, D3
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    before = dict(launch_counts)
    lab = torch.arange(10, dtype=torch.int32, device=dev)
    q = torch.zeros(10, dtype=torch.int32, device=dev)
    out2 = edge_hook(empty, empty, lab, q, 1, mode="sv2", impl=kernel_impl)
    out3 = edge_hook(empty, empty, lab, q, 1, mode="sv3", impl=kernel_impl)
    check(launch_counts == before, "an m2=0 edge_hook call launches nothing")
    check(bool((out2[0] == lab).all() and (out2[1] == q).all()
               and (out3[0] == lab).all() and out3[1].numel() == 0),
          "an m2=0 edge_hook call returns its inputs")
    print("edge_hook m2=0: no launch, inputs returned")

    # The main path's p, and the edges of both paths: one node, an odd
    # size, the one-launch limit and one past it, the step path.
    pj_inputs = {}
    for p in (1, 1000, splitters, splitters + 1, big_p):
        nxt = torch.from_numpy(random_linked_list(p, seed=p)).to(dev)
        w = (nxt != torch.arange(p, dtype=torch.int32, device=dev)).to(torch.int32)
        got = pointer_jump(nxt, w, impl=kernel_impl)
        want = pointer_jump(nxt, w, impl="torch")
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        print(f"pointer_jump p={p}: max_abs_err={err}")
        errs["pointer_jump"] = max(errs.get("pointer_jump", 0), err)
        pj_inputs[p] = (nxt, w)

    rng = np.random.default_rng(0)
    packed = torch.from_numpy(np.stack([
        rng.integers(0, list_n // splitters + 1, list_n),
        rng.integers(0, splitters, list_n),
    ], axis=-1).astype(np.int32)).to(dev)
    sprank = torch.from_numpy(
        rng.integers(0, list_n, splitters).astype(np.int32)).to(dev)
    err = max_abs_err(splitter_aggregate(packed, sprank, impl=kernel_impl),
                      splitter_aggregate(packed, sprank, impl="torch"))
    print(f"splitter_aggregate n={list_n} p={splitters}: max_abs_err={err}")
    errs["splitter_aggregate"] = err
    # Tables past the default 48 KB of shared memory (64 KB) and past the
    # 227 KB a block can have (256 KB: the global-memory variant).
    for p in (16_384, 65_536):
        rows = packed[: list_n // 8].clone()
        rows[:, 1] = torch.randint(0, p, (rows.shape[0],), device=dev,
                                   dtype=torch.int32)
        table = torch.randint(0, list_n, (p,), device=dev, dtype=torch.int32)
        err = max_abs_err(splitter_aggregate(rows, table, impl=kernel_impl),
                          splitter_aggregate(rows, table, impl="torch"))
        print(f"splitter_aggregate n={rows.shape[0]} p={p}: max_abs_err={err}")
        errs["splitter_aggregate"] = max(errs["splitter_aggregate"], err)
    for name, e in errs.items():
        check(e == 0, f"{name} is bit-exact against its plain version")
    return errs, hook_inputs, pj_inputs, (packed, sprank)


def phase_cc(dev, graphs, timer):
    """Phase 3: the CC main path on each graph. Returns the launch
    counts of the checked runs and the report rows."""
    import torch

    from repro_torch.core import connected_components, dedup_edges
    from repro_torch.kernels import launch_counts, reset_launch_counts

    totals = {name: 0 for name in launch_counts}
    rows = []
    for name, src, dst, n, want_count, want_sample_rounds in graphs:
        connected_components(src, dst, n, device=dev)  # warm-up
        reset_launch_counts()
        def call():
            return connected_components(src, dst, n, with_stats=True,
                                        device=dev)

        (labels, rounds, stats), first = timer(call)
        counts = dict(launch_counts)
        secs = [first] + [timer(call)[1] for _ in range(E2E_SAMPLES - 1)]
        s_t = torch.from_numpy(src.astype(np.int64)).to(dev)
        d_t = torch.from_numpy(dst.astype(np.int64)).to(dev)
        check(labels.device.type == dev.type, f"{name}: labels on {dev}")
        check(bool((labels[s_t] == labels[d_t]).all()),
              f"{name}: labels[src] == labels[dst] on every edge")
        check(bool((labels[labels] == labels).all()),
              f"{name}: labels[labels] == labels")
        got_count = int(torch.unique(labels).numel())
        check(got_count == want_count,
              f"{name}: {got_count} components, want {want_count}")
        ref_labels, ref_rounds = connected_components(
            src, dst, n, engine="dense", hook_impl="torch", device=dev)
        if stats.sample_rounds:
            # Sampling picks other roots and takes other rounds.
            check(same_partition(labels, ref_labels),
                  f"{name}: the same partition as the dense plain run")
        else:
            check(ref_rounds == rounds and bool((ref_labels == labels).all()),
                  f"{name}: labels and rounds equal the dense plain run")
        check(stats.sample_rounds == want_sample_rounds,
              f"{name}: {stats.sample_rounds} sampling rounds, want "
              f"{want_sample_rounds}")
        for mode in ("edge_hook.sv2", "edge_hook.sv3"):
            check(counts[mode] == rounds,
                  f"{name}: {mode} launched {counts[mode]} times in "
                  f"{rounds} rounds")
        for k in totals:
            totals[k] += counts[k]
        print(f"cc {name}: n={n} m={len(src)} m2={stats.m2} "
              f"components={got_count} rounds={rounds} "
              f"sample_rounds={stats.sample_rounds} "
              f"live_after_sample={stats.live_after_sample} "
              f"levels={stats.levels} "
              f"edges_touched={stats.edges_touched} "
              f"edge_hook launches={counts['edge_hook.sv2'] + counts['edge_hook.sv3']} "
              f"wall_s={median(secs)} samples={secs}")
        # A separate traced run: the engine's own span against the call,
        # the rest being host preparation (dedup, copy to the card).
        spans, traced_s = timer(lambda: traced(
            lambda: connected_components(src, dst, n, device=dev)))
        t0 = time.perf_counter()
        dedup_edges(src, dst)
        dedup_ms = (time.perf_counter() - t0) * 1e3
        print(f"cc {name} traced: call_ms={traced_s * 1e3} "
              f"cc.frontier_ms={spans['cc.frontier']} "
              f"cc.frontier.level_ms={spans['cc.frontier.level']} "
              f"cc.frontier.sample_ms={spans.get('cc.frontier.sample', 0.0)} "
              f"host_prep_ms={traced_s * 1e3 - spans['cc.frontier'] - spans.get('cc.frontier.sample', 0.0)} "
              f"of which dedup_edges_ms={dedup_ms}")
        wall_ms, device_ms, _, _, idle = device_share(
            lambda: connected_components(src, dst, n, device=dev))
        print(f"cc {name} profiled: wall_ms={wall_ms} device_busy_ms={device_ms} "
              f"device_idle_share={idle}")
        rows.append((name, median(secs)))
    return totals, rows


def phase_list(dev, n, timer):
    """Phase 4: the list-ranking main path. Returns the launch counts of
    the checked run, its wall time, and the traced RS3 share."""
    import torch

    from repro_torch.core import list_rank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ops.kiss import random_linked_list

    succ = random_linked_list(n, seed=0)
    list_rank(succ, device=dev)  # warm-up
    reset_launch_counts()
    def call():
        return list_rank(succ, with_stats=True, device=dev)

    (rank, stats), first = timer(call)
    counts = dict(launch_counts)
    secs = [first] + [timer(call)[1] for _ in range(E2E_SAMPLES - 1)]
    succ_t = torch.from_numpy(succ.astype(np.int64)).to(dev)
    lanes = torch.arange(n, device=dev)
    check(rank.device.type == dev.type, f"ranks on {dev}")
    check(int(rank[0]) == n - 1, "rank[0] == n - 1")
    inner = succ_t != lanes
    check(bool((rank[succ_t[inner]] == rank[inner] - 1).all()),
          "rank[succ[j]] == rank[j] - 1 for every j but the tail")
    check(bool((torch.bincount(rank.long(), minlength=n) == 1).all()),
          "ranks are a permutation of 0..n-1")
    check(counts["pointer_jump"] == 1 and counts["splitter_aggregate"] == 1,
          f"one pointer_jump and one splitter_aggregate launch, got {counts}")

    spans = traced(lambda: list_rank(succ, device=dev))
    walk_share = spans["rank.splitter.walk"] / spans["rank.splitter"]
    print(f"list_rank: n={n} p={len(stats.splitters)} "
          f"walk_steps={stats.walk_steps} wall_s={median(secs)} "
          f"samples={secs} "
          f"traced rank.splitter_ms={spans['rank.splitter']} "
          f"rs3_walk_ms={spans['rank.splitter.walk']} "
          f"rs3_ms_per_step={spans['rank.splitter.walk'] / stats.walk_steps} "
          f"rs3_share={walk_share}")
    # The profiler records every one of the walk's ~17 small operations a
    # step, and summarising 20,000 steps of them takes minutes; a list of
    # PROFILE_LIST_N nodes runs the same loop, shorter.
    small = random_linked_list(PROFILE_LIST_N, seed=0)
    list_rank(small, device=dev)  # warm-up at this size
    wall_ms, device_ms, _, _, idle = device_share(
        lambda: list_rank(small, device=dev))
    print(f"list_rank n={PROFILE_LIST_N} profiled: wall_ms={wall_ms} "
          f"device_busy_ms={device_ms} device_idle_share={idle}")
    return counts, median(secs), walk_share


def kernel_times(hook_inputs, pj_inputs, agg_inputs, splitters, big_p,
                 kernel_impl):
    """Phase 5: each kernel's device time and its plain version's, the
    time of a call from Python, and the bytes each call must move.
    Returns ``{name: (ms, plain_ms, eager_ms, bytes)}``."""
    from repro_torch.kernels.edge_hook.ops import edge_hook
    from repro_torch.kernels.pointer_jump.ops import pointer_jump
    from repro_torch.kernels.splitter_aggregate.ops import splitter_aggregate

    a, b, D1, D, Q, D2, Q2, s, n = hook_inputs
    m2 = a.shape[0]
    nxt, w = pj_inputs[splitters]
    packed, sprank = agg_inputs
    calls = {
        "edge_hook.sv2": (
            lambda impl: edge_hook(a, b, D1, Q, s, labels_prev=D, mode="sv2",
                                   impl=impl),
            hook_bytes("sv2", m2, n)),
        "edge_hook.sv3": (
            lambda impl: edge_hook(a, b, D2, Q2, s, mode="sv3", impl=impl),
            hook_bytes("sv3", m2, n)),
        "pointer_jump": (
            lambda impl: pointer_jump(nxt, w, impl=impl), 16 * splitters),
        "splitter_aggregate": (
            lambda impl: splitter_aggregate(packed, sprank, impl=impl),
            12 * packed.shape[0] + 4 * sprank.shape[0]),
    }
    big_nxt, big_w = pj_inputs[big_p]
    calls["pointer_jump.step_path"] = (
        lambda impl: pointer_jump(big_nxt, big_w, impl=impl), 16 * big_p)
    out = {}
    for name, (fn, nbytes) in calls.items():
        out[name] = (graph_ms(lambda: fn(kernel_impl)),
                     graph_ms(lambda: fn("torch")),
                     cuda_ms(lambda: fn(kernel_impl)), nbytes)
    return out


def cc_graphs():
    """The three CC cells' graphs, ``[(name, edges, n)]``, edges an
    ``(m, 2)`` int32 array."""
    from repro_torch.ops.kiss import giant_dust_graph, random_graph

    return [
        ("giant_dust", giant_dust_graph(CC_GIANT_N, seed=0), CC_GIANT_N),
        ("random", random_graph(CC_RANDOM_N, CC_RANDOM_DENSITY, seed=1), CC_RANDOM_N),
        ("random_dense", random_graph(CC_DENSE_N, CC_DENSE_DENSITY, seed=2),
         CC_DENSE_N),
    ]


def record_hook_calls(graphs, dev) -> dict:
    """Run ``connected_components`` once on each graph with the name
    ``core/components.py`` calls, ``edge_hook``, wrapped; returns each
    cell's calls in order, ``{name: [(mode, a, b, labels, labels_prev,
    stamps, s)]}``, with copies of the labels and stamps each call saw."""
    import repro_torch.core.components as components
    from repro_torch.core import connected_components

    real = components.edge_hook
    calls = []

    def recording(a, b, labels, stamps, s, *, labels_prev=None, mode="sv2",
                  impl="auto"):
        prev = None if labels_prev is None else labels_prev.clone()
        calls.append((mode, a, b, labels.clone(), prev, stamps.clone(), s))
        return real(a, b, labels, stamps, s, labels_prev=labels_prev, mode=mode,
                    impl=impl)

    out = {}
    components.edge_hook = recording
    try:
        for name, edges, n in graphs:
            connected_components(edges[:, 0], edges[:, 1], n, device=dev)
            out[name], calls[:] = list(calls), []
    finally:
        components.edge_hook = real
    return out


def hook_bytes(mode: str, m2: int, n: int) -> int:
    """The bytes one edge_hook call must move: each input read once and
    each output written once."""
    return 8 * m2 + 20 * n if mode == "sv2" else 9 * m2 + 12 * n


def hook_call_times(calls, impl: str = "cuda") -> list:
    """Each recorded call replayed on its own inputs: ``[(mode, ms,
    bound_ms)]`` in call order, ``ms`` by ``graph_ms``."""
    from repro_torch.kernels.edge_hook.ops import edge_hook

    out = []
    for mode, a, b, labels, prev, stamps, s in calls:
        ms = graph_ms(lambda: edge_hook(a, b, labels, stamps, s, labels_prev=prev,
                                        mode=mode, impl=impl), calls=10, replays=3)
        bound = hook_bytes(mode, a.shape[0], labels.shape[0]) / HBM_BYTES_PER_S * 1e3
        out.append((mode, ms, bound))
    return out


def hook_cell_sums(times) -> dict:
    """``{mode: (calls, summed ms, summed bound_ms)}`` of one cell."""
    sums = {}
    for mode, ms, bound in times:
        k, t, bd = sums.get(mode, (0, 0.0, 0.0))
        sums[mode] = (k + 1, t + ms, bd + bound)
    return sums


def pointer_jump_floor_ms(nxt, w) -> float:
    """Device ms of ``pointer_jump_floor`` (``csrc/pointer_jump.cu``):
    the one-launch kernel's launch, loads, stores and barrier steps at
    this ``p``, without its gathers; timed as phase 5 times the kernel."""
    import ctypes

    import torch

    from repro_torch.kernels.build import function
    from repro_torch.kernels.pointer_jump.ops import default_iters

    p = nxt.shape[0]
    fn = function("pointer_jump", "pointer_jump_floor",
                  (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))
    rank_out, nxt_out = torch.empty_like(w), torch.empty_like(nxt)

    def launch():
        status = fn(nxt.data_ptr(), w.data_ptr(), rank_out.data_ptr(),
                    nxt_out.data_ptr(), p, default_iters(p),
                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"pointer_jump_floor launch: CUDA error {status}")

    return graph_ms(launch)


def pointer_jump_step_floor_ms(p: int) -> float:
    """Device ms of the step path's launches alone: ``default_iters(p)``
    dependent launches of ``pointer_jump_step`` on a one-node list, as
    one call at ``p`` makes them (each a node of the CUDA graph), with
    one element's gather each."""
    import ctypes

    import torch

    from repro_torch.kernels.build import function
    from repro_torch.kernels.pointer_jump.ops import default_iters

    fn = function("pointer_jump", "pointer_jump_step",
                  (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p))
    bufs = [torch.zeros(1, dtype=torch.int32, device="cuda") for _ in range(4)]

    def launches():
        src, dst = bufs[:2], bufs[2:]
        for _ in range(default_iters(p)):
            status = fn(src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                        dst[1].data_ptr(), 1, torch.cuda.current_stream().cuda_stream)
            check(status == 0, f"pointer_jump_step launch: CUDA error {status}")
            src, dst = dst, src

    return graph_ms(launches)


def phase_segment_ops(dev) -> None:
    """Phase 2, ``ops/segment.py`` on the card: sorted int64 ids with a
    negative id, ids past ``num_segments`` and past int32 reach the
    kernel sorted, and sum, mean and softmax read what the plain path
    reads."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.ops import segment

    ids = torch.tensor([-(2**32) + 1, 0, 3, 3, 2**32 + 3, 2**40], dtype=torch.int64)
    x = torch.arange(1.0, 7.0)
    before = launch_counts["segment_sum"]
    got = {fn: getattr(segment, fn)(x.to(dev), ids.to(dev), 5, indices_are_sorted=True)
           for fn in ("segment_sum", "segment_mean", "segment_softmax")}
    launched = launch_counts["segment_sum"] - before
    want = {fn: getattr(segment, fn)(x, ids, 5, indices_are_sorted=True) for fn in got}
    print(f"ops/segment.py sorted ids {ids.tolist()}: "
          f"segment_sum={got['segment_sum'].tolist()} "
          f"segment_mean={got['segment_mean'].tolist()} "
          f"segment_softmax={got['segment_softmax'].tolist()} "
          f"kernel launches={launched}")
    check(got["segment_sum"].tolist() == [2.0, 0.0, 0.0, 7.0, 0.0],
          "ops/segment.py segment_sum of the sorted wide ids is [2, 0, 0, 7, 0]")
    check(got["segment_mean"].tolist() == [2.0, 0.0, 0.0, 3.5, 0.0],
          "ops/segment.py segment_mean of the sorted wide ids")
    check(torch.allclose(got["segment_softmax"].cpu(), want["segment_softmax"],
                         rtol=2e-6, atol=0.0),
          "ops/segment.py segment_softmax equals the plain path")
    check(launched == 3, f"three segment_sum launches, got {launched}")


def check_attention_build() -> None:
    """The ptxas report of the bf16 attention kernel's prefill instances
    (``ATTN_ENTRIES``) and of the backward's wgmma instances
    (``ATTN_BWD_ENTRIES``): printed, and no spill allowed in the prefill
    instances and in ``ATTN_BWD_NO_SPILL``."""
    from repro_torch.kernels import build

    for lib, table, no_spill in (
            ("flash_attention", ATTN_ENTRIES, tuple(ATTN_ENTRIES)),
            ("flash_attention_bwd", ATTN_BWD_ENTRIES, ATTN_BWD_NO_SPILL)):
        report = build.ptxas_kernels(lib)
        for label, name in table.items():
            entries = {e: v for e, v in report.items() if name in e}
            check(len(entries) == 1, f"one {name} entry in the ptxas report")
            (entry, info), = entries.items()
            print(f"ptxas {lib} bf16 {label} ({entry}): {info}")
            if label in no_spill:
                check(info.get("spill_stores") == 0 and info.get("spill_loads") == 0,
                      f"no spill in {lib}'s bf16 {label} kernel: {info}")


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """The (query, key) pairs that ``attention_ref`` keeps: the work an
    attention call must do, 2 * (D + Dv) FLOPs per pair (two products)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1, np.int64)
    lo = np.zeros(sq, np.int64) if window is None else np.maximum(q - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound_ms(b, hq, hkv, sq, sk, d, causal, window, itemsize, dv=None):
    """``(bound_ms, flops, bytes)``: the larger of the FLOPs (Q K^T over
    the query/key head dim ``d``, P V over the value head dim ``dv``,
    ``d`` unless given) over the bf16 tensor-core peak and the bytes (q,
    k, v read once, the output written once) over the HBM rate."""
    dv = d if dv is None else dv
    flops = 2 * (d + dv) * b * hq * live_pairs(sq, sk, causal, window)
    nbytes = itemsize * (d + dv) * (b * hq * sq + b * hkv * sk)
    return (max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            flops, nbytes)


def attn_err(got, want, dtype_name: str, name: str) -> float:
    """max |got - want|, checked everywhere against
    ``|got - want| <= tol * rms(want) + tol * |want|``: rtol is the
    dtype's tolerance, and atol the same fraction of the output's own
    size. An output row over N live keys is about sqrt(e / N) in size,
    so a fixed atol of 3e-2 would pass a kernel that dropped tiles at
    long S."""
    import torch

    tol = ATTN_TOL[dtype_name]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: finite output")
    diff = (g - w).abs()
    atol = tol * float(w.square().mean().sqrt())
    over = int((diff > atol + tol * w.abs()).sum())
    err = float(diff.max())
    print(f"flash_attention {name}: max_abs_err={err} mean_abs_err={float(diff.mean())} "
          f"mean_abs_want={float(w.abs().mean())} rtol={tol} atol={atol} "
          f"over_tol={over}")
    check(over == 0, f"{name}: kernel within rtol {tol}, atol {atol} of attention_ref")
    return err


def phase_attention(dev, layer0_qkv):
    """Phase 6: the kernel against ``attention_ref`` at the LM shapes.
    Returns the largest max_abs_err and the inputs of shape (a)."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return tuple(torch.randn(b, h, s, d, device=dev, generator=gen).to(dtype)
                     for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))

    def run(name, q, k, v, causal=True, window=None):
        got = flash_attention(q, k, v, causal=causal, window=window, impl="cuda")
        want = attention_ref(q, k, v, causal=causal, window=window)
        return attn_err(got, want, str(q.dtype), name)

    shape_a = qkv(PREFILL_B, 32, 8, PREFILL_S, PREFILL_S, 128, bf)
    errs = [run(f"(a) B={PREFILL_B} Hq=32 Hkv=8 S={PREFILL_S} D=128 bf16 causal",
                *shape_a)]
    q, k, v = (x.transpose(1, 2) for x in layer0_qkv)
    errs.append(run(f"(b) layer 0 q/k/v of {LM_ARCH} on the prefill tokens "
                    f"{tuple(q.shape)}", q, k, v))
    errs.append(run("(c) gemma MQA Hq=8 Hkv=1 D=256 S=1000 bf16 causal",
                    *qkv(2, 8, 1, 1000, 1000, 256, bf)))
    errs.append(run("(d) phi3 MHA Hq=Hkv=32 D=96 S=777 bf16 causal=False",
                    *qkv(2, 32, 32, 777, 777, 96, bf), causal=False))
    errs.append(run("(e) Hq=32 Hkv=8 D=128 S=2048 bf16 causal window=512",
                    *qkv(1, 32, 8, 2048, 2048, 128, bf), window=512))
    errs.append(run("(f) Hq=32 Hkv=8 D=128 S=1000 float32 causal",
                    *qkv(1, 32, 8, 1000, 1000, 128, f32)))
    # The edges of the bf16 kernel's 128 x 128 tiles, its masks and GQA.
    errs.append(run("(g) S=4097 Hq=32 Hkv=8 D=128 bf16 causal",
                    *qkv(1, 32, 8, 4097, 4097, 128, bf)))
    errs.append(run("(h) Sq=129 Sk=4096 Hq=32 Hkv=8 D=128 bf16 causal",
                    *qkv(1, 32, 8, 129, 4096, 128, bf)))
    errs.append(run("(i) Sq=1 Sk=4096 Hq=32 Hkv=8 D=128 bf16 causal=False",
                    *qkv(1, 32, 8, 1, 4096, 128, bf), causal=False))
    for w in (1, 100):
        errs.append(run(f"(j) S=1000 Hq=32 Hkv=8 D=128 bf16 causal window={w}",
                        *qkv(1, 32, 8, 1000, 1000, 128, bf), window=w))
    errs.append(run("(k) MHA Hq=Hkv=32 D=128 S=1000 bf16 causal",
                    *qkv(1, 32, 32, 1000, 1000, 128, bf)))
    errs.append(run("(l) MQA Hq=32 Hkv=1 D=128 S=1000 bf16 causal",
                    *qkv(1, 32, 1, 1000, 1000, 128, bf)))
    errs.append(run("(n) window=2**40, wider than every distance, S=300 D=128 bf16",
                    *qkv(1, 4, 2, 300, 300, 128, bf), window=2 ** 40))
    # (m) The views attention.py passes: (B, S, H, D) transposed. The
    # kernel reads them in place; the output keeps q's strides, so its
    # transpose back is a view, and it equals the call on copies bit for bit.
    qs, ks, vs = (torch.randn(PREFILL_B, 1000, h, 128, device=dev, generator=gen).to(bf)
                  for h in (32, 8, 8))
    views = [x.transpose(1, 2) for x in (qs, ks, vs)]
    errs.append(run("(m) transposed (B, S, H, D) views, S=1000 D=128 bf16 causal", *views))
    got = flash_attention(*views, impl="cuda")
    dense = flash_attention(*(x.contiguous() for x in views), impl="cuda")
    check(got.stride() == views[0].stride() and got.transpose(1, 2).is_contiguous(),
          f"(m) output strides {got.stride()} are q's {views[0].stride()}")
    check(torch.equal(got, dense), "(m) views and contiguous copies give the same bits")
    print(f"flash_attention (m): output strides {got.stride()}, bit-equal to the "
          "call on contiguous copies")
    del qs, ks, vs, views, got, dense
    for d in (16, 32, 64):
        for dtype in (bf, f32):
            errs.append(run(f"head_dim={d} {dtype} Hq=4 Hkv=2 S=130",
                            *qkv(2, 4, 2, 130, 130, d, dtype)))
    for dtype in (bf, f32):
        errs.append(run(f"rows without a live key {dtype} Sq=300 Sk=100 window=64",
                        *qkv(1, 4, 2, 300, 100, 64, dtype), window=64))
    # An input that requires grad, with grad mode on, goes through the
    # autograd Function: one forward launch, an output with a grad_fn and
    # the bits of the call under no_grad (phase 17 checks its backward).
    q, k, v = (x.clone() for x in qkv(1, 4, 2, 64, 64, 128, bf))
    q.requires_grad_()
    before = launch_counts["flash_attention"]
    graded = flash_attention(q, k, v, impl="cuda")
    check(graded.grad_fn is not None and launch_counts["flash_attention"] == before + 1,
          "a requires_grad q: one forward launch and an output with a grad_fn")
    with torch.no_grad():
        errs.append(run("requires_grad q under torch.no_grad()", q, k, v))
        check(torch.equal(graded.detach(), flash_attention(q, k, v, impl="cuda")),
              "the autograd Function's forward gives the no_grad call's bits")
    print(f"flash_attention: requires_grad q -> grad_fn {type(graded.grad_fn).__name__}")
    del q, k, v, graded
    # Determinism: no atomics, so two calls give the same bits.
    first = flash_attention(*shape_a, impl="cuda")
    check(torch.equal(first, flash_attention(*shape_a, impl="cuda")),
          "(a) two calls give bit-equal outputs")
    print("flash_attention (a): two calls bit-equal")
    del first
    # S = 32768: the kernel's first and last 256 rows against the plain
    # version on those rows alone.
    q, k, v = qkv(1, 32, 8, LONG_S, LONG_S, 128, bf)
    out = flash_attention(q, k, v, impl="cuda")
    n = 256
    errs.append(attn_err(out[:, :, :n], attention_ref(q[:, :, :n], k[:, :, :n], v[:, :, :n]),
                         str(bf), f"S={LONG_S} rows 0..{n - 1}"))
    errs.append(attn_err(out[:, :, -n:],
                         attention_ref(q[:, :, -n:], k, v, q_offset=LONG_S - n),
                         str(bf), f"S={LONG_S} rows {LONG_S - n}..{LONG_S - 1}"))
    del q, k, v, out
    return max(errs), shape_a


def margin_agreement(ref_logits, other_logits, name: str) -> None:
    """Rows whose top-2 margin in ``ref_logits`` exceeds ``MARGIN`` must
    have the same argmax in ``other_logits`` (both (rows, V))."""
    top = ref_logits.float().topk(2, dim=-1).values
    margin = top[:, 0] - top[:, 1]
    sure = margin > MARGIN
    agree = ref_logits.argmax(-1) == other_logits.argmax(-1)
    bad = int((sure & ~agree).sum())
    print(f"{name}: rows={ref_logits.shape[0]} margin>{MARGIN}: {int(sure.sum())} "
          f"argmax agree={int(agree.sum())} disagree_with_margin={bad} "
          f"margins={[round(float(x), 4) for x in margin[:8]]}")
    check(bad == 0, f"{name}: argmaxes agree wherever the margin exceeds {MARGIN}")


def phase_prefill(params, cfg, tokens, timer):
    """Phase 7: ``forward`` at full width; launches counted from 0 in
    the first timed call. Returns the report values."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import forward

    b, s = tokens.shape
    with torch.inference_mode():
        forward(params, cfg, tokens)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits, first = timer(lambda: forward(params, cfg, tokens))
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["flash_attention"] == cfg.num_layers,
              f"flash_attention launched {counts['flash_attention']} times in "
              f"one forward of {cfg.num_layers} layers")
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and logits.dtype == torch.float32, "logits (B, S, V) float32")
        check(bool(torch.isfinite(logits).all()), "finite logits")
        std = float(logits.std())
        del logits
        secs = [first] + [timer(lambda: forward(params, cfg, tokens))[1]
                          for _ in range(E2E_SAMPLES - 1)]
        wall_ms, device_ms, events, ranked, idle = device_share(
            lambda: forward(params, cfg, tokens), top=12)
    # What the op-by-op activation (the reference's bf16 rounding, see
    # models/common.py) costs against one fused call, at this FFN width.
    from repro_torch.models.common import activation_fn

    h = torch.randn(b, s, cfg.d_ff, device=params.embed.device).to(torch.bfloat16)
    act_ms = graph_ms(lambda: activation_fn(cfg.activation)(h))
    fused_ms = graph_ms(lambda: torch.nn.functional.silu(h))
    del h
    print(f"prefill activation {cfg.activation} on ({b}, {s}, {cfg.d_ff}) bf16: "
          f"op_by_op_ms={act_ms} fused_silu_ms={fused_ms} "
          f"per_forward_extra_ms={(act_ms - fused_ms) * cfg.num_layers}")
    med = median(secs)
    print(f"prefill {LM_ARCH} B={b} S={s}: wall_ms={med * 1e3} "
          f"samples_ms={[x * 1e3 for x in secs]} tokens_per_s={b * s / med} "
          f"flash_attention launches={counts['flash_attention']} "
          f"peak_memory_gb={peak_gb} logits_std={std}")
    print(f"prefill profiled: wall_ms={wall_ms} device_busy_ms={device_ms} "
          f"device_events={events} device_idle_share={idle}")
    for name, ms in ranked:
        print(f"prefill device time by kernel: {ms:.3f} ms {name[:110]}")
    return counts, med, b * s / med, peak_gb, idle


def phase_consistency(params, cfg, tokens):
    """Phase 8: ``forward``'s logits at every position against those of
    the decode path, ``prefill``'s loop (``init_kv_cache``, then one
    ``serve_step`` per token) with each step's logits kept."""
    import torch

    from repro_torch.models.transformer import forward, init_kv_cache, serve_step

    b, s = tokens.shape
    with torch.inference_mode():
        full = forward(params, cfg, tokens)
        tok = torch.from_numpy(tokens).to(full.device)
        cache = init_kv_cache(cfg, b, s, device=full.device)
        dec = torch.empty_like(full)
        for i in range(s):
            logits, cache = serve_step(params, cfg, cache, tok[:, i:i + 1], i)
            dec[:, i] = logits[:, 0]
        del cache
    diff = (full - dec).abs()
    row_max = diff.amax(-1).reshape(-1)
    max_diff = float(row_max.max())
    print(f"prefill vs decode B={b} S={s}, every position: "
          f"max_abs_diff={max_diff} mean_abs_diff={float(diff.mean())} "
          f"row_max_abs_diff p50={float(row_max.median())} "
          f"p99={float(row_max.quantile(0.99))} "
          f"last_position_max_abs_diff={float(diff[:, -1].max())} "
          f"logit_std={float(dec.std())} limit={CONSISTENCY_MAX_DIFF}")
    margin_agreement(dec.reshape(b * s, -1), full.reshape(b * s, -1),
                     "prefill vs decode")
    check(max_diff <= CONSISTENCY_MAX_DIFF,
          f"prefill vs decode: max |delta| {max_diff} within {CONSISTENCY_MAX_DIFF}")


def phase_serving(params, cfg, slots: int, max_len: int, n_requests: int,
                  profile: bool, *, label: str = LM_ARCH, prompts=None,
                  rescore: bool = True):
    """Phase 9: the LM engine at full width with ``slots`` slots of
    ``max_len`` rows on ``n_requests`` requests (two waves), on
    ``prompts`` or random ones of 16-128 tokens. Where ``rescore``, the
    first request is re-scored by ``forward``. Returns the report values;
    the idle share only where ``profile``."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import forward
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(0)
    if prompts is None:
        lengths = rng.integers(16, 129, n_requests)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    lengths = np.asarray([len(p) for p in prompts])
    eng = ServeEngine(params, cfg, num_slots=slots, max_len=max_len)
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=SERVE_NEW))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    done, secs = wall_s(eng.run)
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    h = eng.health_records[-1]
    snap = eng.metrics.snapshot()
    tokens = sum(len(r.output) for r in done)
    check(eng.waves == 2 and h.completed == n_requests and h.failed == 0,
          f"2 waves, {n_requests} completed, 0 failed: got {eng.waves}, "
          f"{h.completed}, {h.failed}")
    check(all(len(r.output) == SERVE_NEW and r.done for r in done),
          f"{SERVE_NEW} tokens for every request")
    steps = snap["serve.lm.steps"]
    cell = f"serve {label} slots={slots} max_len={max_len} requests={n_requests}"
    print(f"{cell} prompt_lengths={lengths.tolist()} "
          f"new_tokens={SERVE_NEW}: wall_s={secs} waves={eng.waves} "
          f"steps={steps} decode_tokens={tokens} decode_tokens_per_s={tokens / secs} "
          f"ms_per_step={secs * 1e3 / steps} peak_memory_gb={peak_gb} "
          f"launches={counts}")
    # Re-score the first request with forward (teacher-forced).
    if rescore:
        r = min(done, key=lambda x: x.uid)
        seq = r.prompt + r.output
        with torch.inference_mode():
            logits = forward(params, cfg, np.asarray([seq]))[0]
        p = len(r.prompt)
        rows = logits[p - 1:p - 1 + len(r.output)]
        margin_agreement(rows, torch.nn.functional.one_hot(
            torch.tensor(r.output, device=rows.device), rows.shape[-1]).float(),
            f"{cell}: request {r.uid} re-scored by forward")
    idle = None
    if profile:
        # The idle share of a short run of the same engine, one wave.
        engines = []

        def wave():
            engines.clear()  # one engine's KV cache at a time
            engines.append(ServeEngine(params, cfg, num_slots=slots,
                                       max_len=max_len))
            for uid in range(slots):
                engines[0].submit(Request(uid=uid, prompt=prompts[uid][:16],
                                          max_new_tokens=8))
            return engines[0].run

        wall_ms, device_ms, events, ranked, idle = device_share(
            top=6, prepare=wave)
        small_steps = engines[0].metrics.snapshot()["serve.lm.steps"]
        print(f"{cell} profiled ({slots} requests, 16-token prompts, 8 new tokens, "
              f"{small_steps} steps): wall_ms={wall_ms} device_busy_ms={device_ms} "
              f"device_events={events} device_events_per_step={events / small_steps} "
              f"ms_per_step={wall_ms / small_steps} device_idle_share={idle}")
        for name, ms in ranked:
            print(f"serve device time by kernel: {ms:.3f} ms {name[:110]}")
    return tokens / secs, steps, secs * 1e3 / steps, peak_gb, idle


def forward_with_lse(q, k, v) -> None:
    """Phase 10: the forward writing each row's log-sum-exp (as
    ``_Attention`` calls it) against the forward without, at shape (a):
    the same output bits, and its median time over ``ATTN_LSE_ROUNDS``
    rounds of turns (without, with, with, without) within
    ``ATTN_LSE_SLOWDOWN`` of the forward's without. Each turn is
    ``ATTN_LSE_ITERS`` calls from Python (the card, not the host, sets
    their pace at this shape), so both sides reuse the same cached
    output buffers; one short turn of the same call spreads by 3-6% on
    an H100 (PERF.md section 7)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_lse

    out, lse = flash_attention_lse(q, k, v, impl="cuda")
    check(torch.equal(out, flash_attention(q, k, v, impl="cuda")),
          "(a) the forward writing lse gives the output's bits")
    check(bool(torch.isfinite(lse).all()), "(a) every row's lse is finite")
    without = lambda: flash_attention(q, k, v, impl="cuda")  # noqa: E731
    with_lse = lambda: flash_attention_lse(q, k, v, impl="cuda")  # noqa: E731
    turns = {without: [], with_lse: []}
    for _ in range(ATTN_LSE_ROUNDS):
        for fn in (without, with_lse, with_lse, without):
            turns[fn].append(cuda_ms(fn, iters=ATTN_LSE_ITERS, warmup=3))
    plain_ms, lse_ms = median(turns[without]), median(turns[with_lse])
    print(f"time flash_attention (a) with lse written: ms={lse_ms} without: ms={plain_ms} "
          f"ratio={lse_ms / plain_ms} (medians of {2 * ATTN_LSE_ROUNDS} turns each; with "
          f"{turns[with_lse]}, without {turns[without]}); outputs bit-equal")
    check(lse_ms <= ATTN_LSE_SLOWDOWN * plain_ms,
          f"the forward writing lse within {ATTN_LSE_SLOWDOWN}x of the forward without")
    del out, lse


def attention_times(shape_a, dev):
    """Phase 10: the kernel's device time at shape (a) and at S=32768,
    the time per Python call, the plain version's and SDPA's. Returns
    the record fields of shape (a)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = shape_a
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    bound_ms, flops, nbytes = attention_bound_ms(b, hq, hkv, s, s, d, True, None, 2)
    ms = graph_ms(lambda: flash_attention(q, k, v, impl="cuda"))
    forward_with_lse(q, k, v)
    eager_ms = cuda_ms(lambda: flash_attention(q, k, v, impl="cuda"), iters=20)
    # The plain version allocates ~13 GB a call: timed from Python, where
    # at 20+ ms a call the host's share is small.
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v), iters=3, warmup=1)
    sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(f"time flash_attention B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 causal: "
          f"ms={ms} eager_ms={eager_ms} plain_ms={plain_ms} sdpa_ms={sdpa_ms} "
          f"bound_ms={bound_ms} flops={flops} bytes={nbytes} "
          f"share_of_bound={bound_ms / ms} tflops={flops / ms / 1e9}")
    gen = torch.Generator(dev).manual_seed(2)
    ql, kl, vl = (torch.randn(1, h, LONG_S, 128, device=dev, generator=gen).to(torch.bfloat16)
                  for h in (32, 8, 8))
    long_bound, long_flops, _ = attention_bound_ms(1, 32, 8, LONG_S, LONG_S, 128,
                                                   True, None, 2)
    long_ms = graph_ms(lambda: flash_attention(ql, kl, vl, impl="cuda"), calls=2, replays=2)
    long_sdpa = graph_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, enable_gqa=True), calls=2, replays=2)
    print(f"time flash_attention B=1 Hq=32 Hkv=8 S={LONG_S} D=128 bf16 causal: "
          f"ms={long_ms} sdpa_ms={long_sdpa} bound_ms={long_bound} "
          f"share_of_bound={long_bound / long_ms} tflops={long_flops / long_ms / 1e9} "
          f"plain: not run (its scores would take "
          f"{32 * LONG_S * LONG_S * 4 / 1e9:.0f} GB)")
    del ql, kl, vl
    # How the share of the bound moves with the rows' length, beside SDPA.
    for b, s_len, causal in ATTN_SWEEP:
        qs, ks, vs = (torch.randn(b, h, s_len, 128, device=dev, generator=gen).to(torch.bfloat16)
                      for h in (32, 8, 8))
        bound, _, _ = attention_bound_ms(b, 32, 8, s_len, s_len, 128, causal, None, 2)
        k_ms = graph_ms(lambda: flash_attention(qs, ks, vs, causal=causal, impl="cuda"))
        s_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True))
        print(f"time flash_attention B={b} Hq=32 Hkv=8 S={s_len} D=128 bf16 causal={causal}: "
              f"ms={k_ms} sdpa_ms={s_ms} bound_ms={bound} share_of_bound={bound / k_ms} "
              f"sdpa_share_of_bound={bound / s_ms}")
    return ms, plain_ms, eager_ms, sdpa_ms, bound_ms



def max_degree(ids, n: int) -> int:
    """The largest number of rows of one segment in ``[0, n)``."""
    import torch

    valid = ids[(ids >= 0) & (ids < n)].long()
    return int(torch.bincount(valid, minlength=n).max()) if valid.numel() else 0


def segsum_check(name, data, ids, n) -> float:
    """The kernel against its plain version on one input; returns the
    largest |err| (``segsum_within``)."""
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    got = segment_sum_sorted(data, ids, n, impl="cuda")
    want = segment_sum_sorted(data, ids, n, impl="torch")
    check(got.shape == want.shape and got.dtype == want.dtype == data.dtype,
          f"segment_sum {name}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    deg = max_degree(ids, n)
    return segsum_within(
        f"segment_sum {name}: m={ids.shape[0]} n={n} feat={tuple(data.shape[1:])} "
        f"{data.dtype} max_degree={deg}", got, want, deg)


def segsum_within(label, got, want, deg: int) -> float:
    """``|got - want| <= atol + rtol * |want|`` everywhere, ``got``
    finite; returns the largest |err|. rtol is the dtype's, atol
    ``SEGSUM_ATOL`` times the output's rms times sqrt(max degree), since
    a sum of k rows in another order differs by about sqrt(k) roundings
    of its size."""
    import torch

    g, w = got.float(), want.float()
    check(g.shape == w.shape, f"{label}: shapes {tuple(g.shape)} vs {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{label}: finite output")
    rtol = SEGSUM_RTOL[str(want.dtype)]
    atol = SEGSUM_ATOL * float(w.square().mean().sqrt()) * max(deg, 1) ** 0.5
    diff = (g - w).abs()
    over = int((diff > atol + rtol * w.abs()).sum())
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"{label} max_abs_err={err} rtol={rtol} atol={atol} over_tol={over}")
    check(over == 0, f"{label}: within tolerance")
    return err


def segsum_bit_equal(name, data, ids, n) -> None:
    """Two calls of the kernel on the same input give bit-equal outputs
    (no atomics: a fixed order of sums)."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted

    a = segment_sum_sorted(data, ids, n, impl="cuda")
    b = segment_sum_sorted(data, ids, n, impl="cuda")
    same = torch.equal(a, b)
    print(f"segment_sum {name}: two calls bit-equal={same}")
    check(same, f"segment_sum {name}: two calls bit-equal")


def segsum_pointers(name, ids, n) -> None:
    """The row pointers the kernel's tile pass writes equal
    ``torch.searchsorted(ids, arange(n + 1))`` bit for bit."""
    import torch

    from repro_torch.kernels.segment_sum.ops import segment_sum_and_pointers

    ones = torch.ones(ids.shape[0], 1, device=ids.device)
    ptr = segment_sum_and_pointers(ones, ids, n)[1]
    want = torch.searchsorted(
        ids, torch.arange(n + 1, dtype=torch.int32, device=ids.device), out_int32=True)
    same = torch.equal(ptr, want)
    print(f"segment_sum {name}: row pointers equal torch.searchsorted={same}")
    check(same, f"segment_sum {name}: row pointers equal torch.searchsorted")


def phase_segment_sum(dev, dst: np.ndarray) -> float:
    """Phase 2, ``segment_sum``: the kernel against its plain version at
    the GNN path's shapes and at the edge cases, two calls bit-equal, and
    its row pointers against ``torch.searchsorted``. Returns the largest
    max_abs_err at the main path's (ogb_products, float32) shapes."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import molecule_batch
    from repro_torch.kernels.segment_sum import segment_sum_sorted

    gen = torch.Generator(dev).manual_seed(3)
    ids = torch.from_numpy(dst).to(dev)
    errs = []
    for feat, dtype, what in (
            ((GNN_D,), torch.float32, "gin-tu layer 1"),
            ((64,), torch.float32, "gin-tu layers 2-5"),
            ((8, 8), torch.float32, "gat-cora layer 1 messages"),
            ((8,), torch.float32, "gat-cora layer 1 denominators"),
            ((1, GNN_CLASSES), torch.float32, "gat-cora layer 2 messages"),
            ((1,), torch.float32, "gat-cora layer 2 denominators"),
            ((64,), torch.bfloat16, "bf16")):
        data = torch.randn((GNN_M, *feat), device=dev, generator=gen).to(dtype)
        err = segsum_check(f"{GNN_SHAPE} {what}", data, ids, GNN_N)
        if dtype == torch.float32:
            errs.append(err)
        if feat == (GNN_D,):
            segsum_bit_equal(f"{GNN_SHAPE} {what}", data, ids, GNN_N)
        del data
    segsum_pointers(GNN_SHAPE, ids, GNN_N)
    del ids
    pl_ids = power_law_ids(dev, gen)
    data = torch.randn(GNN_M, 64, device=dev, generator=gen)
    segsum_check("power-law (m, 64)", data, pl_ids, GNN_N)
    del data, pl_ids
    hub_ids, hub_data = hub_case(dev, gen)
    segsum_check("hub", hub_data, hub_ids, HUB_N)
    segsum_check("hub bf16", hub_data.to(torch.bfloat16), hub_ids, HUB_N)
    segsum_bit_equal("hub", hub_data, hub_ids, HUB_N)
    segsum_pointers("hub", hub_ids, HUB_N)
    one = torch.zeros(HUB_M, dtype=torch.int32, device=dev)
    segsum_check("one segment owning every row", hub_data, one, 1)
    # Empty segments (every other one), negative ids and sentinels: the
    # reference's padding id n, and ns_pad + block_s.
    n = 1 << 20
    body = torch.randint(0, n // 2, (1 << 22,), device=dev, generator=gen) * 2
    ids = torch.cat([torch.tensor([-9, -1, -1], device=dev), body,
                     torch.tensor([n, n, n + 256 + 1000], device=dev)])
    ids = ids.sort().values.to(torch.int32)
    data = torch.randn(ids.shape[0], 24, device=dev, generator=gen)
    segsum_check("empty, negative and sentinel ids", data, ids, n)
    got = segment_sum_sorted(data, ids, n, impl="cuda")
    check(not bool(got[1::2].any()), "empty segments sum to 0")
    segsum_pointers("empty, negative and sentinel ids", ids, n)
    del got, data, ids, body, hub_ids, hub_data, one
    # Rows wider than a column block (MAX_COLS), copied row by row: the
    # molecule cell's graph readout (hcat, layers x hidden columns, over
    # graph_ids), one column past a block, and Cora's 1,433 features, the
    # last two on a hub that crosses fold groups.
    mol = molecule_batch(MOLECULE_BATCH)
    mol_cfg = get_arch("gin-tu").config_for("molecule")
    gids = torch.from_numpy(mol["graph_ids"]).to(dev)
    width = mol_cfg.num_layers * mol_cfg.d_hidden
    wide = [(f"molecule readout (nodes, {width})", gids, int(mol["num_graphs"]),
             torch.randn(gids.shape[0], width, device=dev, generator=gen))]
    for d in WIDE_COLS:
        ids, data = hub_case(dev, gen, WIDE_HUB_M, WIDE_HUB_N, d)
        wide.append((f"hub (2^18, {d})", ids, WIDE_HUB_N, data))
    for name, ids, n, data in wide:
        for dtype in (torch.float32, torch.bfloat16):
            x = data.to(dtype)
            segsum_check(f"{name} {dtype}", x, ids, n)
            segsum_bit_equal(f"{name} {dtype}", x, ids, n)
            del x
    del wide, data, ids
    torch.cuda.empty_cache()
    return max(errs)


def hub_case(dev, gen, m: int = HUB_M, n: int = HUB_N, d: int = 64):
    """m sorted ids over n segments, one of which owns a tenth of the
    rows, with (m, d) float32 rows."""
    import torch

    hub = m // 10
    rest = torch.randint(0, n, (m - hub,), device=dev, generator=gen)
    ids = torch.cat([rest, torch.full((hub,), n // 2, device=dev)])
    ids = ids.sort().values.to(torch.int32)
    return ids, torch.randn(m, d, device=dev, generator=gen)


def power_law_draws(dev, gen, n: int, m: int):
    """m ids over n nodes in the order drawn (int64), node r drawn with
    weight (r + 1) ** -POWER_LAW."""
    import torch

    weights = (torch.arange(n, device=dev, dtype=torch.float64) + 1) ** -POWER_LAW
    return torch.cat([
        torch.multinomial(weights, min(1 << 24, m - i), replacement=True, generator=gen)
        for i in range(0, m, 1 << 24)])


def power_law_ids(dev, gen):
    """GNN_M sorted destinations over the GNN_N nodes, node r drawn with
    weight (r + 1) ** -POWER_LAW: a products graph's in-degrees, whose
    largest segment holds about 1.1% of the rows. Prints the degrees."""
    import torch

    ids = power_law_draws(dev, gen, GNN_N, GNN_M).sort().values.to(torch.int32)
    deg = torch.bincount(ids.long(), minlength=GNN_N)
    print(f"power-law ids: m={GNN_M} n={GNN_N} weight (r+1)^-{POWER_LAW}: "
          f"max_degree={int(deg.max())} segments_over_10k_rows={int((deg > 10_000).sum())} "
          f"median_degree={float(deg.float().median())} empty={int((deg == 0).sum())}")
    return ids


def segment_sum_times(dev, dst: np.ndarray):
    """Phase 5, ``segment_sum``: device ms (CUDA-graph replays), ms per
    Python call, plain ms, ``torch.segment_reduce`` and ``index_add_``
    ms, and the byte bound, at gin-tu's and gat-cora's shapes on the
    ogb_products ids, the power-law case and the hub case; at gin-tu's
    layer-1 shape also the kernel's passes by device time and
    ``torch.searchsorted``'s time for the row pointers, which the tile
    pass writes. Returns the layer-1 record fields."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted

    gen = torch.Generator(dev).manual_seed(4)
    ogb_ids = torch.from_numpy(dst).to(dev)
    pl_ids = power_law_ids(dev, gen)
    hub_ids, hub_data = hub_case(dev, gen)
    cases = (
        (f"{GNN_SHAPE} gin-tu layer 1 (m, {GNN_D})", ogb_ids, GNN_N, (GNN_D,)),
        (f"{GNN_SHAPE} gin-tu layers 2-5 (m, 64)", ogb_ids, GNN_N, (64,)),
        (f"{GNN_SHAPE} gat-cora layer 1 messages (m, 8, 8)", ogb_ids, GNN_N, (8, 8)),
        (f"{GNN_SHAPE} gat-cora layer 1 denominators (m, 8)", ogb_ids, GNN_N, (8,)),
        (f"{GNN_SHAPE} gat-cora layer 2 messages (m, 1, {GNN_CLASSES})", ogb_ids, GNN_N,
         (1, GNN_CLASSES)),
        (f"{GNN_SHAPE} gat-cora layer 2 denominators (m, 1)", ogb_ids, GNN_N, (1,)),
        (f"power-law (m, 64), max degree {max_degree(pl_ids, GNN_N)}", pl_ids, GNN_N, (64,)),
        ("hub (2^22, 64), one segment of 2^22 / 10 rows", hub_ids, HUB_N, (64,)),
    )
    first = None
    for name, ids, n, feat in cases:
        data = (hub_data if ids is hub_ids
                else torch.randn((ids.shape[0], *feat), device=dev, generator=gen))
        times = time_segsum(dev, name, data, ids, n)
        if first is None:
            first = times
            ms = times[0]

            def kernel():
                return segment_sum_sorted(data, ids, n, impl="cuda")

            search_ms = graph_ms(lambda: torch.searchsorted(
                ids, torch.arange(n + 1, dtype=torch.int32, device=dev), out_int32=True),
                calls=10, replays=3)
            _, busy_ms, _, passes, _ = device_share(kernel, top=4)
            print(f"split segment_sum {name}: passes by device ms "
                  f"{[(k, round(v, 4)) for k, v in passes]} busy_ms={busy_ms}; "
                  f"torch.searchsorted for the row pointers (which the tile pass "
                  f"writes) ms={search_ms} share_of_call={search_ms / ms}")
        del data
    del ogb_ids, pl_ids, hub_ids, hub_data
    torch.cuda.empty_cache()
    return first


def time_segsum(dev, name, data, ids, n):
    """``segment_sum``'s times on one input: device ms (CUDA-graph
    replays), ms per Python call, plain ms, ``torch.segment_reduce`` and
    ``index_add_`` ms, and the byte bound at 3.35 TB/s; printed, and
    returned as ``(ms, plain_ms, eager_ms, segment_reduce_ms, bound_ms)``."""
    import torch

    from repro_torch.kernels.segment_sum import segment_sum_sorted
    from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

    m, d = ids.shape[0], math.prod(data.shape[1:])
    flat = data.view(m, d)
    lengths = torch.bincount(ids.long(), minlength=n)
    long_ids = ids.long()

    def kernel():
        return segment_sum_sorted(data, ids, n, impl="cuda")

    def plain():
        return segment_sum_sorted_ref(data, ids, n)

    ms = graph_ms(kernel, calls=10, replays=3)
    eager_ms = cuda_ms(kernel, iters=10, warmup=2)
    plain_ms = graph_ms(plain, calls=3, replays=3)
    lib_ms = cuda_ms(lambda: torch.segment_reduce(flat, "sum", lengths=lengths),
                     iters=5, warmup=1)
    add_ms = cuda_ms(lambda: torch.zeros(n, d, device=dev, dtype=data.dtype).index_add_(
        0, long_ids, flat), iters=5, warmup=1)
    lib_err = float((torch.segment_reduce(flat, "sum", lengths=lengths)
                     - kernel().view(n, d)).abs().max())
    s = data.element_size()
    nbytes = m * d * s + 4 * m + n * d * s + 4 * (n + 1)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"time segment_sum {name}: ms={ms} eager_ms={eager_ms} "
          f"plain_ms={plain_ms} segment_reduce_ms={lib_ms} "
          f"index_add_ms={add_ms} bound_ms={bound_ms} bytes={nbytes} "
          f"share_of_bound={bound_ms / ms} "
          f"gb_per_s={nbytes / ms / 1e6} "
          f"segment_reduce_max_abs_diff={lib_err} [{card_line()}]")
    return ms, plain_ms, eager_ms, lib_ms, bound_ms


def gnn_by_index_add(name, params, cfg, graph):
    """The logits of gin-tu or gat-cora computed independently of the
    port's aggregation path: plain ``index_add_`` sums over unsorted-safe
    int64 ids, ``scatter_reduce`` maxima, ``F.layer_norm``, and the same
    layers on the same parameters. With grad mode on, each gin-tu layer's
    gather and sum is recomputed in the backward: ``index_add_``'s
    autograd keeps its (m, d) source alive, and the layers' gathers
    together pass the card's memory on ogb_products."""
    import torch
    import torch.nn.functional as F
    from torch.utils.checkpoint import checkpoint

    h = graph["node_feats"]
    n = h.shape[0]
    src, dst = graph["src"].long(), graph["dst"].long()

    def agg(msgs, index, rows):
        out = torch.zeros((rows, *msgs.shape[1:]), dtype=msgs.dtype,
                          device=msgs.device)
        return out.index_add_(0, index, msgs)

    def gather_sum(x):
        return agg(x[src], dst, n)

    if name == "gin-tu":
        reps = []
        for layer in params.layers:
            summed = (checkpoint(gather_sum, h, use_reentrant=False)
                      if torch.is_grad_enabled() else gather_sum(h))
            z = (1.0 + layer.eps) * h + summed
            z = F.linear(F.relu(F.linear(z, layer.w1.weight, layer.w1.bias)),
                         layer.w2.weight, layer.w2.bias)
            h = F.layer_norm(z, (z.shape[-1],), layer.ln_g, layer.ln_b, eps=1e-5)
            reps.append(h)
        hcat = torch.cat(reps, dim=-1)
        if cfg.readout == "graph":
            hcat = agg(hcat, graph["graph_ids"].long(), int(graph["num_graphs"]))
        return F.linear(hcat, params.head.weight, params.head.bias)
    for i, layer in enumerate(params.layers):
        last = i == len(params.layers) - 1
        heads = 1 if last else cfg.num_heads
        d_out = cfg.num_classes if last else cfg.d_hidden
        wh = (h @ layer.w.weight.T).reshape(n, heads, d_out)
        s_src = (wh * layer.a_src).sum(-1)
        s_dst = (wh * layer.a_dst).sum(-1)
        e = F.leaky_relu(s_src[src] + s_dst[dst], cfg.negative_slope)
        top = torch.full((n, heads), float("-inf"), device=h.device)
        top.scatter_reduce_(0, dst[:, None].expand_as(e), e, "amax")
        top = torch.where(torch.isfinite(top), top, 0.0)
        p = torch.exp(e - top[dst])
        del e
        den = agg(p, dst, n).clamp_min(torch.finfo(p.dtype).tiny)
        out = agg(wh[src] * p[..., None], dst, n) / den[..., None]
        del p
        h = out.mean(dim=1) if last else F.elu(out.reshape(n, -1) + layer.b)
    return h


def check_logits(name, got, want):
    """``got`` within rtol = GNN_TOL of ``want`` and an atol of GNN_TOL
    times the smaller of 1 and ``want``'s rms (so a cell of small logits,
    gat-cora's rms is about 0.05, is held to its own scale), and the same
    argmax wherever ``want``'s top-2 margin exceeds GNN_MARGIN."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{name}: logits {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: finite logits")
    diff = (got - want).abs()
    atol = GNN_TOL * min(1.0, float(want.square().mean().sqrt()))
    over = int((diff > atol + GNN_TOL * want.abs()).sum())
    top = want.topk(2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > GNN_MARGIN
    agree = got.argmax(-1) == want.argmax(-1)
    bad = int((sure & ~agree).sum())
    print(f"{name} vs gnn_by_index_add: max_abs_diff={float(diff.max())} "
          f"mean_abs_diff={float(diff.mean())} logit_std={float(want.std())} "
          f"atol={atol} over_tol={over} rows={want.shape[0]} margin>{GNN_MARGIN}: "
          f"{int(sure.sum())} argmax_agree={int(agree.sum())} "
          f"disagree_with_margin={bad}")
    check(over == 0, f"{name}: logits within tolerance of the independent forward")
    check(bad == 0, f"{name}: argmaxes agree wherever the margin exceeds {GNN_MARGIN}")


def gnn_cell(dev, name, shape, graph, want_launches, profile: bool):
    """One GNN cell: ``forward`` of ``name`` at ``config_for(shape)`` on
    ``graph`` (tensors on the card), launches counted from 0 in the
    first timed call, checked against ``gnn_by_index_add``; where
    ``profile``, the idle share and top device kernels of one profiled
    call. Returns the report values."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    arch = get_arch(name)
    cfg = arch.config_for(shape)
    fwd = arch.module.forward
    params = arch.module.init_params(
        cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    m = graph["src"].shape[0]
    with torch.inference_mode():
        fwd(params, cfg, graph)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits, first = wall_s(lambda: fwd(params, cfg, graph))
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["segment_sum"] == want_launches,
              f"{name} {shape}: segment_sum launched {counts['segment_sum']} "
              f"times in one forward, want {want_launches}")
        secs = [first] + [wall_s(lambda: fwd(params, cfg, graph))[1]
                          for _ in range(E2E_SAMPLES - 1)]
        check_logits(f"{name} {shape}", logits,
                     gnn_by_index_add(name, params, cfg, graph))
        del logits
        idle = None
        if profile:
            wall_ms, device_ms, events, ranked, idle = device_share(
                lambda: fwd(params, cfg, graph), top=8)
            print(f"gnn {name} {shape} profiled: wall_ms={wall_ms} "
                  f"device_busy_ms={device_ms} device_events={events} "
                  f"device_idle_share={idle}")
            for kname, ms in ranked:
                print(f"gnn {name} device time by kernel: {ms:.3f} ms {kname[:110]}")
    med = median(secs)
    print(f"gnn {name} {shape}: n={graph['node_feats'].shape[0]} m={m} "
          f"layers={cfg.num_layers} readout={getattr(cfg, 'readout', 'node')} "
          f"wall_ms={med * 1e3} samples_ms={[x * 1e3 for x in secs]} "
          f"edges_per_s={cfg.num_layers * m / med} "
          f"segment_sum launches={counts['segment_sum']} peak_memory_gb={peak_gb}")
    del params
    return med, cfg.num_layers * m / med, peak_gb, idle, counts["segment_sum"]


def gnn_on_card(g: dict, dev) -> dict:
    import torch

    out = {k: torch.from_numpy(np.ascontiguousarray(g[k])).to(dev)
           for k in ("node_feats", "src", "dst", "graph_ids")}
    out["num_graphs"] = int(g["num_graphs"])
    return out


def phase_gnn(dev, ogb: dict) -> dict:
    """Phase 11: GNN inference on the ogb_products graph, each cell
    profiled, and on a molecule batch. Returns ``{cell: (seconds,
    edges/s, peak GB, idle share, launches)}``."""
    import torch

    from repro_torch.data.graphs import molecule_batch

    graph = gnn_on_card(ogb, dev)
    print(f"gnn graph {GNN_SHAPE} on the card: "
          f"{sum(v.numel() * v.element_size() for k, v in graph.items() if k != 'num_graphs') / 1e9} GB")
    cells = {}
    for name, launches in GNN_ARCHS:
        cells[(name, GNN_SHAPE)] = gnn_cell(dev, name, GNN_SHAPE, graph,
                                            launches, profile=True)
        torch.cuda.empty_cache()
    del graph
    mol = gnn_on_card(molecule_batch(MOLECULE_BATCH), dev)
    cells[("gin-tu", "molecule")] = gnn_cell(
        dev, "gin-tu", "molecule", mol, MOLECULE_LAUNCHES, profile=False)
    torch.cuda.empty_cache()
    return cells


def phase_lm(dev) -> dict:
    """Phases 6-10 on qwen3-4b at full width."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import init_params
    from repro_torch.models.transformer.attention import qkv_projections
    from repro_torch.models.transformer.model import as_tokens, embed_lookup

    cfg = get_arch(LM_ARCH).config
    t0 = time.perf_counter()
    params = init_params(cfg, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {LM_ARCH}: params={n_params} dtype={cfg.dtype} "
          f"init_s={time.perf_counter() - t0} "
          f"memory_gb={torch.cuda.memory_allocated() / 1e9}")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_S))
    with torch.inference_mode():
        tok = as_tokens(params, tokens)
        layer = params.dense_layers[0]
        positions = torch.arange(PREFILL_S, dtype=torch.int32, device=dev)
        layer0_qkv = qkv_projections(
            layer.attn, cfg, rms_norm(embed_lookup(params, cfg, tok), layer.ln1),
            positions[None].expand(PREFILL_B, PREFILL_S))
    max_err, shape_a = phase_attention(dev, layer0_qkv)
    del layer0_qkv
    mla_err = phase_attention_mla(dev)
    counts, prefill_s, tps, peak_gb, idle = phase_prefill(
        params, cfg, tokens, wall_s)
    phase_consistency(params, cfg, tokens[:, :CONSISTENCY_S])
    serving = [phase_serving(params, cfg, *cell) for cell in SERVE_CELLS]
    del params
    torch.cuda.empty_cache()
    return {
        "counts": counts, "max_abs_err": max_err, "mla_err": mla_err,
        "prefill_s": prefill_s, "prefill_tps": tps, "prefill_peak_gb": peak_gb,
        "prefill_idle": idle, "serving": serving,
        "times": attention_times(shape_a, dev),
    }


def float_err(x, y, what: str) -> float:
    """Largest |x - y| over two float tensors of one shape; raises unless
    they are equal bit for bit."""
    import torch

    if x.shape != y.shape:
        raise RuntimeError(f"shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.numel() == 0:
        return 0.0
    bits = torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))
    err = float((x.double() - y.double()).abs().nan_to_num(0.0).max())
    check(bits, f"{what}: bit for bit (max_abs_err {err})")
    return err


def sssp_weights(m: int) -> np.ndarray:
    """Phase 12's float32 edge weights, uniform in [0, 1)."""
    return np.random.default_rng(SSSP_WEIGHT_SEED).random(m).astype(np.float32)


def phase_ordered_fold(dev, edges: np.ndarray, n: int, weights: np.ndarray):
    """Phase 2, ``ordered_fold`` against its plain version on the card,
    bit for bit: PageRank's degrees and first mass step on phase 12's
    graph (the degrees also against ``np.add.at``), the mass step in both
    forms (generic, on ``dmp * (out[a] * w2)`` written out; fused, the
    kernel gathering ``out`` and multiplying itself), which must also
    agree with each other; empty groups and a one-group buffer in both
    forms; PAGERANK_M2 power-law ids over n groups (also against
    ``np.add.at``, and the fused form on them against ``np.add.at``); and
    a star of STAR_LEAVES arcs into one hub against ``np.add.at`` (the
    plain version would take STAR_LEAVES steps). Returns the largest
    error and the inputs phase 5 times."""
    import torch

    from repro_torch.core.components import oriented_edges
    from repro_torch.kernels.ordered_fold.ops import (
        fold_plan,
        ordered_fold_gathered,
        ordered_fold_sorted,
    )

    def both(name, base, plan, vals):
        got = ordered_fold_sorted(base, plan.row_ptr, plan.perm, vals, impl="cuda")
        err = float_err(got, ordered_fold_sorted(base, plan.row_ptr, plan.perm,
                                                 vals, impl="torch"),
                        f"ordered_fold {name} against its plain version")
        print(f"ordered_fold {name}: groups={base.numel()} slots={vals.numel()} "
              f"max_abs_err={err}")
        return got, err

    def both_gathered(name, args):
        got = ordered_fold_gathered(*args, impl="cuda")
        err = float_err(got, ordered_fold_gathered(*args, impl="torch"),
                        f"ordered_fold fused {name} against its plain version")
        print(f"ordered_fold fused {name}: groups={args[0].numel()} "
              f"slots={args[2].numel()} max_abs_err={err}")
        return got, err

    def add_at(name, got, base, ids, vals):
        want = base.cpu().numpy()
        np.add.at(want, ids.cpu().numpy(), vals.cpu().numpy())
        err = float_err(got.cpu(), torch.from_numpy(want),
                        f"ordered_fold {name} against np.add.at")
        print(f"ordered_fold {name}: against np.add.at max_abs_err={err}")
        return err

    def sorted_args(base, plan, a, node, w, scale):
        perm = plan.perm
        return (base, plan.row_ptr, a.index_select(0, perm), node,
                w.index_select(0, perm), scale)

    a, b = oriented_edges(edges[:, 0], edges[:, 1], n, device=dev)
    w = torch.from_numpy(weights).to(dev)
    w2 = torch.cat([w, w])
    a_plan, b_plan = fold_plan(a, n), fold_plan(b, n)
    deg, err = both("pagerank degrees", torch.zeros(n, device=dev), a_plan, w2)
    errs = [err, add_at("degrees", deg, torch.zeros(n, device=dev), a, w2)]
    dmp = torch.tensor(np.float32(0.85), device=dev)
    omd = torch.tensor(np.float32(1.0) - np.float32(0.85), device=dev)
    t = torch.full((n,), 1.0 / n, device=dev)
    out = torch.where(deg > 0, t / deg, 0.0)
    mass = (omd * t, b_plan, dmp * (out[a] * w2))
    generic, err = both("pagerank mass step", *mass)
    fused = sorted_args(omd * t, b_plan, a, out, w2, dmp)
    got, err_f = both_gathered("pagerank mass step", fused)
    errs += [err, err_f, float_err(got, generic, "ordered_fold mass step: fused "
                                   "against generic")]
    gen = torch.Generator(device=dev).manual_seed(12)
    groups = 1 << 16
    idx = 3 * torch.randint(0, groups // 3, (1 << 20,), device=dev, generator=gen)
    vals = torch.randn(1 << 20, device=dev, generator=gen)
    base = torch.randn(groups, device=dev, generator=gen)
    plan = fold_plan(idx, groups)
    errs.append(both("two empty groups in three", base, plan, vals)[1])
    src = torch.randint(0, groups, (1 << 20,), device=dev, generator=gen,
                        dtype=torch.int32)
    errs.append(both_gathered("two empty groups in three", sorted_args(
        base, plan, src, base, vals, dmp))[1])
    one = torch.randn(4096, device=dev, generator=gen) * 1e3
    one_plan = fold_plan(torch.zeros(4096, dtype=torch.int32, device=dev), 1)
    got, e1 = both("one group", torch.zeros(1, device=dev), one_plan, one)
    errs += [e1, add_at("one group", got, torch.zeros(1, device=dev),
                        torch.zeros(4096, dtype=torch.int64), one)]
    errs.append(both_gathered("one group", (
        torch.zeros(1, device=dev), one_plan.row_ptr,
        torch.zeros(4096, dtype=torch.int32, device=dev), one[:1].contiguous(),
        one, dmp))[1])
    pl_ids = power_law_draws(dev, gen, n, PAGERANK_M2).to(torch.int32)
    pl_vals = torch.randn(PAGERANK_M2, device=dev, generator=gen)
    pl_base = torch.randn(n, device=dev, generator=gen)
    pl_plan = fold_plan(pl_ids, n)
    got, err = both("power-law ids", pl_base, pl_plan, pl_vals)
    errs += [err, add_at("power-law ids", got, pl_base, pl_ids, pl_vals)]
    pl_src = torch.randint(0, n, (PAGERANK_M2,), device=dev, generator=gen,
                           dtype=torch.int32)
    pl_w = torch.rand(PAGERANK_M2, device=dev, generator=gen)
    pl_node = torch.rand(n, device=dev, generator=gen)
    pl_fused = sorted_args(pl_base, pl_plan, pl_src, pl_node, pl_w, dmp)
    got = ordered_fold_gathered(*pl_fused, impl="cuda")
    errs.append(add_at("fused power-law ids", got, pl_base, pl_ids,
                       dmp * (pl_node[pl_src.long()] * pl_w)))
    pl_deg = int(torch.diff(pl_plan.row_ptr).max())
    print(f"ordered_fold power-law ids: n={n} m2={PAGERANK_M2} weight "
          f"(r+1)^-{POWER_LAW}: max_degree={pl_deg}")
    hub_vals = torch.randn(STAR_LEAVES, device=dev, generator=gen)
    hub_base = torch.randn(STAR_LEAVES + 1, device=dev, generator=gen)
    hub_plan = fold_plan(torch.zeros(STAR_LEAVES, dtype=torch.int32, device=dev),
                         STAR_LEAVES + 1)
    got = ordered_fold_sorted(hub_base, hub_plan.row_ptr, hub_plan.perm, hub_vals,
                              impl="cuda")
    errs.append(add_at(f"star of {STAR_LEAVES} arcs into one hub", got, hub_base,
                       torch.zeros(STAR_LEAVES, dtype=torch.int64), hub_vals))
    return max(errs), {
        "mass": (mass, b.long()), "fused": fused,
        "power_law": (pl_base, pl_plan, pl_vals, pl_ids.long(), pl_deg),
        "hub": (hub_base, hub_plan, hub_vals)}


def chain_floor_ms(adds: int) -> float:
    """Device ms of ``ordered_fold_chain_floor`` (``csrc/ordered_fold.cu``):
    one thread adding ``adds`` values from registers, each
    ``__fadd_rn`` waiting on the last: the least time a bit-exact fold of
    a target with ``adds`` slots can take."""
    import ctypes

    import torch

    from repro_torch.kernels.build import function

    fn = function("ordered_fold", "ordered_fold_chain_floor",
                  (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p))
    src = torch.tensor([1e-8, 2e-8, 3e-8, 4e-8, 1.0], device="cuda")
    out = torch.empty(1, device="cuda")

    def launch():
        status = fn(src.data_ptr(), out.data_ptr(), adds,
                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"ordered_fold_chain_floor launch: CUDA error {status}")

    return graph_ms(launch, calls=2, replays=2)


def ordered_fold_times(inputs, card: str):
    """Phase 5, ``ordered_fold``: device ms (CUDA graph replays), ms per
    Python call, the plain version's ms per call (CUDA events around
    Python calls: it reads the degrees to the host, so a CUDA graph
    cannot hold it), ``torch.index_add`` on the same values (the
    yardstick: it sums through atomics in no fixed order, so it is not
    the same function), the byte bound, the floor that L2's
    random-sector rate sets on the gathers (``L2_SECTORS_PER_S``) and the
    chain floor (the largest degree times one add's latency, from
    ``chain_floor_ms``): PageRank's mass step generic and fused, the
    power-law ids and the star's hub. Returns the fused mass step's
    ``(ms, plain_ms, eager_ms, library_ms, bound_ms)``, the record of the
    call the main path makes each iteration."""
    import torch

    from repro_torch.kernels.ordered_fold.ops import (
        ordered_fold_gathered,
        ordered_fold_sorted,
    )

    ((base, plan, vals), b_long) = inputs["mass"]
    fused = inputs["fused"]
    pl_base, pl_plan, pl_vals, pl_ids, pl_deg = inputs["power_law"]
    hub_base, hub_plan, hub_vals = inputs["hub"]
    n, m2 = base.numel(), vals.numel()
    chain_ms = chain_floor_ms(STAR_LEAVES)
    add_ms = chain_ms / STAR_LEAVES
    print(f"time ordered_fold chain floor: {STAR_LEAVES} dependent __fadd_rn in one "
          f"thread ms={chain_ms} ns_per_add={add_ms * 1e6} [{card}]")
    mass_deg = int(torch.diff(plan.row_ptr).max())

    def row(name, fold, plain, lib, nbytes, gathers, max_deg, **kw):
        ms = graph_ms(fold, **kw)
        eager = cuda_ms(fold, iters=kw.get("calls", 20))
        plain_ms = None if plain is None else cuda_ms(plain, iters=3, warmup=1)
        lib_ms = graph_ms(lib)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        l2 = gathers / L2_SECTORS_PER_S * 1e3
        print(f"time ordered_fold {name}: ms={ms} eager_ms={eager} plain_ms={plain_ms} "
              f"library_ms(index_add)={lib_ms} bound_ms={bound} bytes={nbytes} "
              f"share_of_bound={bound / ms} l2_floor_ms={l2} max_degree={max_deg} "
              f"chain_floor_ms={max_deg * add_ms} [{card}]")
        return ms, plain_ms, eager, lib_ms, bound

    def sorted_call(b, p, v, impl="cuda"):
        return lambda: ordered_fold_sorted(b, p.row_ptr, p.perm, v, impl=impl)

    row("mass step generic", sorted_call(base, plan, vals),
        sorted_call(base, plan, vals, "torch"),
        lambda: torch.index_add(base, 0, b_long, vals), 8 * m2 + 12 * n + 4, m2,
        mass_deg)
    record = row("mass step fused", lambda: ordered_fold_gathered(*fused, impl="cuda"),
                 lambda: ordered_fold_gathered(*fused, impl="torch"),
                 lambda: torch.index_add(base, 0, b_long, vals),
                 8 * m2 + 16 * n + 8, m2, mass_deg)
    row("power-law ids", sorted_call(pl_base, pl_plan, pl_vals), None,
        lambda: torch.index_add(pl_base, 0, pl_ids, pl_vals),
        8 * pl_vals.numel() + 12 * n + 4, pl_vals.numel(), pl_deg)
    hub_ids = torch.zeros(STAR_LEAVES, dtype=torch.int64, device=hub_vals.device)
    row("star hub", sorted_call(hub_base, hub_plan, hub_vals), None,
        lambda: torch.index_add(hub_base, 0, hub_ids, hub_vals),
        8 * STAR_LEAVES + 12 * hub_base.numel() + 4, STAR_LEAVES, STAR_LEAVES,
        calls=2, replays=2)
    return record


def sssp_by_scipy(src, dst, w, n, sources) -> np.ndarray:
    """float64 Dijkstra distances from scipy, independent of the port:
    both orientations, the least weight of each repeated arc."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    ww = np.concatenate([w, w]).astype(np.float64)
    order = np.lexsort((ww, v, u))
    u, v, ww = u[order], v[order], ww[order]
    first = np.ones(len(u), bool)
    first[1:] = (u[1:] != u[:-1]) | (v[1:] != v[:-1])
    g = csr_matrix((ww[first], (u[first], v[first])), shape=(n, n))
    return dijkstra(g, directed=True, indices=np.asarray(sources))


def check_sssp_tree(name, a, b, w2, dist, parent, sources) -> None:
    """The fixpoint holds on every arc, in float32, and every reachable
    non-source node's parent arc is tight; unreachable nodes have no
    parent. ``dist``/``parent`` are (S, n)."""
    import torch

    for row, s in enumerate(sources):
        d, p = dist[row], parent[row]
        check(bool((d[b] <= d[a] + w2).all()), f"{name} source {s}: fixpoint on every arc")
        tight = (d[a] + w2 == d[b]) & (a == p[b.long()]) & (a != b)
        has = torch.zeros(d.numel(), dtype=torch.int32, device=d.device)
        has.scatter_reduce_(0, b.long(), tight.to(torch.int32), "amax")
        reach = torch.isfinite(d)
        nonsrc = torch.ones_like(reach)
        nonsrc[int(s)] = False
        check(bool((has.bool() | ~(reach & nonsrc)).all()),
              f"{name} source {s}: every reachable node's parent arc is tight")
        check(bool(((p == -1) == ~reach).all()) and int(p[int(s)]) == int(s),
              f"{name} source {s}: parents -1 exactly where unreachable")


def phase_sssp(dev, edges, n, weights, timer) -> dict:
    """Phase 12, SSSP through ``shortest_paths`` from one source and from
    a batch of four. Returns ``{label: (median s, rounds)}``."""
    import torch

    from repro_torch.core import shortest_paths
    from repro_torch.core.components import oriented_edges

    src, dst = edges[:, 0], edges[:, 1]
    a, b = oriented_edges(src, dst, n, device=dev)
    w2 = torch.from_numpy(np.concatenate([weights, weights])).to(dev)
    rows = {}
    solo = {}
    for label, sources in (("solo", 0), ("batch", np.array(SSSP_BATCH, np.int32))):
        def call(sources=sources):
            return shortest_paths(src, dst, weights, n, sources=sources,
                                  with_stats=True, device=dev)

        call()  # warm-up
        (dist, parent, rounds, st), first = timer(call)
        secs = [first] + [timer(call)[1] for _ in range(E2E_SAMPLES - 1)]
        (dd, dp, dr, dst_), dense_s = timer(lambda sources=sources: shortest_paths(
            src, dst, weights, n, sources=sources, engine="dense",
            with_stats=True, device=dev))
        check(dr == rounds and torch.equal(dd, dist) and torch.equal(dp, parent),
              f"sssp {label}: the frontier engine equals the dense engine bit "
              f"for bit (rounds {rounds} / {dr})")
        srcs = np.atleast_1d(sources)
        d2, p2 = dist.reshape(len(srcs), n), parent.reshape(len(srcs), n)
        check_sssp_tree(f"sssp {label}", a, b, w2, d2, p2, srcs)
        if label == "solo":
            solo[0] = (dist, parent)
        else:
            for row, s in enumerate(srcs):
                if int(s) not in solo:
                    solo[int(s)] = shortest_paths(src, dst, weights, n,
                                                  sources=int(s), device=dev)[:2]
                check(torch.equal(d2[row], solo[int(s)][0])
                      and torch.equal(p2[row], solo[int(s)][1]),
                      f"sssp batch row {row} (source {s}) equals its solo run")
            t0 = time.perf_counter()
            ref = sssp_by_scipy(src, dst, weights, n, srcs)
            got = d2.double().cpu().numpy()
            fin = np.isfinite(ref)
            check(np.array_equal(fin, np.isfinite(got)),
                  "sssp: the same nodes reachable as scipy's dijkstra")
            rel = float((np.abs(got[fin] - ref[fin])
                         / np.maximum(np.abs(ref[fin]), 1e-30)).max())
            check(rel <= SSSP_RTOL, f"sssp: within {SSSP_RTOL} of scipy's float64 "
                                    f"dijkstra (largest relative error {rel})")
            print(f"sssp batch against scipy dijkstra: reachable={int(fin.sum())} "
                  f"of {fin.size} max_rel_err={rel} "
                  f"host_s={time.perf_counter() - t0}")
        print(f"sssp {label}: n={n} m2={st.m2} sources={st.num_sources} "
              f"rounds={rounds} relax_visits={st.relax_visits} "
              f"mask_visits={st.mask_visits} levels={len(st.levels)} "
              f"dense relax_visits={dst_.relax_visits} dense_wall_s={dense_s} "
              f"max_dist={float(dist[torch.isfinite(dist)].max())} "
              f"wall_s={median(secs)} samples={secs}")
        rows[label] = (median(secs), rounds)
    return rows


def pagerank_checked(dev, edges, n, weights, timer, label: str):
    """A warm-up ``pagerank`` call to tol = 1e-6, then a checked one:
    ``ordered_fold`` launched once for the degrees and once per
    iteration, the dense engine at the same iterations bit-equal, finite
    scores, and PAGERANK_ORACLE_ITERS iterations bit-equal to the numpy
    ``serial_pagerank``. Returns the checked call's seconds, scores,
    iterations, stats, launches and the oracle's host seconds."""
    import torch

    from repro_torch.core import pagerank
    from repro_torch.core.serial import serial_pagerank
    from repro_torch.kernels import launch_counts, reset_launch_counts

    src, dst = edges[:, 0], edges[:, 1]

    def call():
        return pagerank(src, dst, weights, n, engine="frontier", with_stats=True,
                        device=dev)

    call()  # warm-up
    reset_launch_counts()
    (scores, iters, st), secs = timer(call)
    launches = launch_counts["ordered_fold"]
    check(launches == iters + 1,
          f"pagerank {label}: ordered_fold launched once for the degrees and once "
          f"per iteration ({launches} launches, {iters} iterations)")
    dense, dense_it = pagerank(src, dst, weights, n, engine="dense",
                               num_iters=iters, device=dev)
    check(dense_it == iters and torch.equal(dense, scores),
          f"pagerank {label}: the dense engine at the same iterations is bit-equal")
    few, _ = pagerank(src, dst, weights, n, engine="dense",
                      num_iters=PAGERANK_ORACLE_ITERS, device=dev)
    t0 = time.perf_counter()
    want = serial_pagerank(edges, weights, n, num_iters=PAGERANK_ORACLE_ITERS)
    oracle_s = time.perf_counter() - t0
    float_err(few.cpu(), torch.from_numpy(want),
              f"pagerank {label}: {PAGERANK_ORACLE_ITERS} iterations against "
              f"serial_pagerank")
    check(bool(torch.isfinite(scores).all()) and scores.shape == (n,),
          f"pagerank {label}: finite scores, one a node")
    return secs, scores, iters, st, launches, oracle_s


def power_law_graph(dev, n: int):
    """PAGERANK_M2 // 2 edges over n nodes: uniform sources, destinations
    drawn with weight (r + 1) ** -POWER_LAW (as ``power_law_draws``, from a
    seeded card generator), as a host ``(m, 2)`` int32 array."""
    import torch

    m = PAGERANK_M2 // 2
    gen = torch.Generator(device=dev).manual_seed(14)
    dst = power_law_draws(dev, gen, n, m).to(torch.int32).cpu().numpy()
    src = np.random.default_rng(4).integers(0, n, m).astype(np.int32)
    return np.stack([src, dst], axis=1)


def phase_pagerank(dev, edges, n, weights, timer):
    """Phase 12, PageRank through ``pagerank`` to tol = 1e-6, and the
    dense engine at ``pagerank_iter_bound()`` iterations (tol is absolute,
    and at n = 2^20 every score moves less than 1e-6 within a few
    iterations); then the checks once more on a power-law graph of as
    many arcs (``power_law_graph``, ``default_rng(3)`` weights). Returns
    the tolerance run's median seconds, iterations, ``ordered_fold``
    launches of the checked run and profiled idle share, and the dense
    run's median seconds and launches."""
    from repro_torch.core import pagerank, pagerank_iter_bound
    from repro_torch.kernels import launch_counts, reset_launch_counts

    src, dst = edges[:, 0], edges[:, 1]
    first, scores, iters, st, launches, oracle_s = pagerank_checked(
        dev, edges, n, weights, timer, "random")
    secs = [first] + [timer(lambda: pagerank(src, dst, weights, n, device=dev))[1]
                      for _ in range(E2E_SAMPLES - 1)]
    bound = pagerank_iter_bound()

    def fixed():
        return pagerank(src, dst, weights, n, engine="dense", device=dev)

    fixed()  # warm-up
    reset_launch_counts()
    (_, fixed_it), first = timer(fixed)
    fixed_launches = launch_counts["ordered_fold"]
    fixed_secs = [first] + [timer(fixed)[1] for _ in range(E2E_SAMPLES - 1)]
    check(fixed_it == bound and fixed_launches == bound + 1,
          f"pagerank dense: {bound} iterations, ordered_fold launched "
          f"{fixed_launches} times (want {bound + 1})")
    wall_ms, busy_ms, _, top, idle = device_share(
        lambda: pagerank(src, dst, weights, n, engine="frontier", device=dev),
        top=4)
    print(f"pagerank: n={n} m2={st.m2} iterations={iters} "
          f"edges_touched={st.edges_touched} ordered_fold launches={launches} "
          f"num_iters={PAGERANK_ORACLE_ITERS} equals serial_pagerank bit for bit "
          f"(numpy host_s={oracle_s}) score_sum={float(scores.double().sum())} "
          f"wall_s={median(secs)} samples={secs}")
    print(f"pagerank profiled: wall_ms={wall_ms} device_busy_ms={busy_ms} "
          f"device_idle_share={idle} top={top}")
    print(f"pagerank dense num_iters={bound}: ordered_fold launches="
          f"{fixed_launches} wall_s={median(fixed_secs)} samples={fixed_secs}")
    pl = power_law_graph(dev, n)
    pl_secs, pl_scores, pl_iters, pl_st, pl_launches, pl_oracle_s = pagerank_checked(
        dev, pl, n, sssp_weights(len(pl)), timer, "power-law")
    pl_deg = int(np.bincount(pl.ravel(), minlength=n).max())
    print(f"pagerank power-law: n={n} m2={pl_st.m2} max_degree={pl_deg} "
          f"iterations={pl_iters} ordered_fold launches={pl_launches} "
          f"num_iters={PAGERANK_ORACLE_ITERS} equals serial_pagerank bit for bit "
          f"(numpy host_s={pl_oracle_s}) dense equals frontier "
          f"score_sum={float(pl_scores.double().sum())} wall_s={pl_secs}")
    return median(secs), iters, launches, idle, median(fixed_secs), fixed_launches


@functools.lru_cache(maxsize=1)
def tree_families():
    """Phase 12's tree inputs, ``{family: (n, edges)}``, and the
    molecule-batch forest's host build seconds."""
    from repro_torch.data.graphs import random_tree, random_tree_forest

    path = np.stack([np.arange(TREE_N - 1, dtype=np.int32),
                     np.arange(1, TREE_N, dtype=np.int32)], axis=1)
    t0 = time.perf_counter()
    mol = random_tree_forest(TREE_MOLECULE_N, TREE_MOLECULE_N // 30, seed=2)
    build_s = time.perf_counter() - t0
    return {
        "path": (TREE_N, path),
        "one-tree": (TREE_N, random_tree(TREE_N, seed=1)),
        "molecule-batch": (TREE_MOLECULE_N, mol),
    }, build_s


def check_tree_invariants(name, comp, root_of) -> None:
    """Vectorised invariants of one forest's tree computations: roots
    point at themselves at depth 0, a child is one deeper than its
    parent, a subtree is one plus its children's, and preorder and
    postorder are permutations within each tree."""
    import torch

    parent, depth, size = comp.parent.long(), comp.depth, comp.subtree_size
    n = parent.numel()
    nodes = torch.arange(n, device=parent.device)
    is_root = root_of.long() == nodes
    check(bool((parent[is_root] == nodes[is_root]).all()
               and (depth[is_root] == 0).all()
               and (parent[~is_root] != nodes[~is_root]).all()),
          f"{name}: roots point at themselves at depth 0, no other node does")
    check(bool((depth[~is_root] == depth[parent[~is_root]] + 1).all()),
          f"{name}: depth[v] == depth[parent[v]] + 1")
    kids = torch.zeros(n, dtype=torch.int64, device=parent.device)
    kids.index_add_(0, parent[~is_root], size[~is_root].long())
    check(bool((size.long() == kids + 1).all()),
          f"{name}: subtree_size[v] == 1 + the sum over its children")
    tsize = torch.where(is_root, size.long(), 0)
    base = torch.cumsum(tsize, 0) - tsize
    own = tsize[root_of.long()]
    for field in ("preorder", "postorder"):
        order = getattr(comp, field).long()
        code = base[root_of.long()] + order
        check(bool(((order >= 0) & (order < own)).all()
                   and (torch.bincount(code, minlength=n) == 1).all()),
              f"{name}: {field} is a permutation within each tree")


def phase_trees(dev, timer) -> dict:
    """Phase 12, tree analytics through ``tree_analytics`` on the three
    families of ``benchmarks/tree_ops.py``, on both rank engines, then
    each stage timed; and the splitter path against the port's serial
    oracle on a TREE_ORACLE_N-node forest. Returns ``{family: report}``."""
    import torch

    from repro_torch.core import tree_analytics
    from repro_torch.core.list_ranking import random_splitter_rank, wylie_rank
    from repro_torch.data.graphs import random_tree_forest
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.pointer_jump.ops import SHARED_LIMIT, default_iters
    from repro_torch.trees import (
        euler_tour,
        spanning_forest,
        tour_splitters,
        tree_computations,
    )
    from repro_torch.trees.reference import serial_tree_reference

    families, build_s = tree_families()
    print(f"trees molecule-batch random_tree_forest({TREE_MOLECULE_N}, "
          f"{TREE_MOLECULE_N // 30}, seed=2): host_s={build_s}")
    fields = ("parent", "depth", "subtree_size", "preorder", "postorder")
    out = {}
    for fam, (n, edges) in families.items():
        u, v = edges[:, 0], edges[:, 1]
        runs = {}
        for eng in ("splitter", "wylie"):
            reset_launch_counts()
            ta, secs = timer(lambda eng=eng: tree_analytics(
                u, v, n, rank_engine=eng, device=dev))
            runs[eng] = (ta, dict(launch_counts), secs)
        (ta, counts, ta_s), (tw, wcounts, tw_s) = runs["splitter"], runs["wylie"]
        for k in fields:
            check(torch.equal(getattr(ta.computations, k),
                              getattr(tw.computations, k)),
                  f"trees {fam}: {k} equal on both rank engines")
        check_tree_invariants(f"trees {fam}", ta.computations, ta.tour.root_of)
        rounds = ta.forest.rounds
        p = len(tour_splitters(ta.tour))
        want_pj = 1 if p <= SHARED_LIMIT else default_iters(p)
        for c, name in ((counts, "splitter"), (wcounts, "wylie")):
            check(c["edge_hook.sv2"] == rounds and c["edge_hook.sv3"] == rounds,
                  f"trees {fam} {name}: edge_hook launched twice a CC round ({c}, "
                  f"{rounds} rounds)")
        check(counts["splitter_aggregate"] == 1 and counts["pointer_jump"] == want_pj,
              f"trees {fam}: one splitter_aggregate launch and {want_pj} "
              f"pointer_jump launches at p={p}, got {counts}")
        check(wcounts["splitter_aggregate"] == 0 and wcounts["pointer_jump"] == 0,
              f"trees {fam}: wylie launches no list-ranking kernel ({wcounts})")
        if fam == "molecule-batch":
            check(p > SHARED_LIMIT, f"trees {fam}: p={p} takes pointer_jump's step path")
        # Each stage on its own; the two runs above were its warm-ups.
        stage = {}

        def timed(name, fn):
            res, s = timer(fn)
            samples = [s]
            if s < 5.0:
                samples += [timer(fn)[1] for _ in range(E2E_SAMPLES - 1)]
            stage[name] = (median(samples), len(samples))
            return res

        forest = timed("forest", lambda: spanning_forest(u, v, n, device=dev))
        tour = timed("tour", lambda: euler_tour(
            forest.edge_u, forest.edge_v, n, labels=forest.labels, device=dev))
        spl = tour_splitters(tour)
        ranks, rs = timed("rank_splitter", lambda: random_splitter_rank(
            tour.succ, splitters=spl, with_stats=True))
        timed("rank_wylie", lambda: wylie_rank(tour.succ))
        timed("analytics", lambda: tree_computations(tour, ranks=ranks))
        comp = tree_computations(tour, ranks=ranks)
        for k in fields:
            check(torch.equal(getattr(comp, k), getattr(ta.computations, k)),
                  f"trees {fam}: the staged run equals tree_analytics ({k})")
        report = dict(
            n=n, trees=ta.forest.num_trees, arcs=ta.tour.num_arcs,
            capacity=ta.tour.capacity, cc_rounds=rounds, p=p,
            walk_steps=rs.walk_steps, max_depth=int(ta.depth.max()),
            size_sum=int(ta.subtree_size.long().sum()),
            launches={k: c for k, c in counts.items() if c},
            tree_analytics_splitter_s=ta_s, tree_analytics_wylie_s=tw_s,
            stages={k: f"{s} s (median of {k_n})" if k_n > 1 else f"{s} s (one call)"
                    for k, (s, k_n) in stage.items()},
        )
        print(f"trees {fam}: " + " ".join(f"{k}={v}" for k, v in report.items()))
        out[fam] = report
        del runs, ta, tw, forest, tour, ranks, comp
        torch.cuda.empty_cache()
    n = TREE_ORACLE_N
    e = random_tree_forest(n, n // 30, seed=2)
    ta = tree_analytics(e[:, 0], e[:, 1], n, rank_engine="splitter", device=dev)
    want = serial_tree_reference(ta.forest.edge_u, ta.forest.edge_v, n)
    for k in fields:
        check(np.array_equal(getattr(ta.computations, k).cpu().numpy(), want[k]),
              f"trees oracle forest n={n}: {k} equals serial_tree_reference")
    print(f"trees oracle: random_tree_forest({n}, {n // 30}, seed=2) splitter "
          f"path equals serial_tree_reference bit for bit")
    n, edges = families["path"]
    tree_analytics(edges[:, 0], edges[:, 1], n, device=dev)  # warm-up
    wall_ms, busy_ms, _, top, idle = device_share(
        lambda: tree_analytics(edges[:, 0], edges[:, 1], n, device=dev), top=4)
    print(f"trees path tree_analytics (rank_engine auto: wylie) profiled: "
          f"wall_ms={wall_ms} device_busy_ms={busy_ms} device_idle_share={idle} "
          f"top={top}")
    out["path"]["idle"] = idle
    return out


def phase_graph_analytics(dev, edges, n, weights, timer) -> dict:
    """Phase 12: SSSP, PageRank and tree analytics on the card."""
    t0 = time.perf_counter()
    sssp = phase_sssp(dev, edges, n, weights, timer)
    pr = phase_pagerank(dev, edges, n, weights, timer)
    trees = phase_trees(dev, timer)
    print(f"phase 12 graph analytics: s={time.perf_counter() - t0}")
    return {"sssp": sssp, "pagerank": pr, "trees": trees}


def bench_counters(name: str) -> str:
    """The counters of a ``BENCH_smoke.json`` row: its derived string
    without the wall-time entries (``~p10_us``...)."""
    rows = json.loads((ROOT / "BENCH_smoke.json").read_text())
    derived = next(r["derived"] for r in rows if r["name"] == name)
    return ";".join(p for p in derived.split(";") if not p.startswith("~"))


def serve_requests(stream, device, **knobs):
    """Serve ``stream`` (``graph_request_stream`` entries) through one
    ``GraphServeEngine``; returns the engine, its finished requests by
    uid, and each wave's seconds (every wave ends in a read of its
    outputs, so the host clock times it)."""
    from repro_torch.serve import GraphRequest, GraphServeEngine

    eng = GraphServeEngine(device=device, **knobs)
    for i, g in enumerate(stream):
        eng.submit(GraphRequest(uid=i, **g))
    wave_s = []
    run_wave = eng._run_wave

    def timed(wave):
        t0 = time.perf_counter()
        try:
            return run_wave(wave)
        finally:
            wave_s.append(time.perf_counter() - t0)

    eng._run_wave = timed
    done = {r.uid: r for r in eng.run()}
    check(len(done) == len(stream) and all(r.done for r in done.values()),
          f"serve_graphs: all {len(stream)} requests served")
    return eng, done, wave_s


def same_result(x, y) -> bool:
    """Two ``GraphResult``s equal field by field, bit for bit."""
    import dataclasses

    for f in dataclasses.fields(x):
        a, b = getattr(x, f.name), getattr(y, f.name)
        if a is None or b is None:
            if a is not b:
                return False
        elif isinstance(a, np.ndarray):
            if a.dtype != b.dtype or a.shape != b.shape:
                return False
            if a.dtype.kind == "f":
                if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                    return False
            elif not np.array_equal(a, b):
                return False
        elif a != b:
            return False
    return True


def check_served(label, kind, stream, results, iters) -> None:
    """Each served request against an oracle independent of the engine:
    component counts by numpy propagation, forests of n - components
    edges, the tree invariants, SSSP against scipy's Dijkstra, PageRank
    against ``serial_pagerank`` bit for bit."""
    import types

    import torch

    from repro_torch.core.serial import serial_pagerank

    for uid, g in enumerate(stream):
        res, n = results[uid].result, g["num_nodes"]
        name = f"serve_graphs {label} request {uid}"
        if kind in ("cc", "forest", "analytics"):
            want = components_by_propagation(g["src"], g["dst"], n)
            check(res.num_components == want,
                  f"{name}: {res.num_components} components, want {want}")
        if kind in ("forest", "analytics"):
            check(len(res.edge_u) == n - res.num_components,
                  f"{name}: a spanning forest of n - components edges")
        if kind == "analytics":
            comp = types.SimpleNamespace(**{
                k: torch.from_numpy(getattr(res, k)) for k in
                ("parent", "depth", "subtree_size", "preorder", "postorder")})
            check_tree_invariants(name, comp, torch.from_numpy(res.labels))
        if kind == "sssp":
            ref = sssp_by_scipy(g["src"], g["dst"], g["weights"], n, g["sources"])
            fin = np.isfinite(ref)
            check(np.array_equal(fin, np.isfinite(res.dist)),
                  f"{name}: the same nodes reachable as scipy's dijkstra")
            rel = (np.abs(res.dist[fin] - ref[fin])
                   / np.maximum(np.abs(ref[fin]), 1e-30))
            check(rel.size == 0 or float(rel.max()) <= SSSP_RTOL,
                  f"{name}: within {SSSP_RTOL} of scipy's dijkstra")
        if kind == "pagerank":
            want = serial_pagerank(np.stack([g["src"], g["dst"]], axis=1),
                                   g["weights"], n, num_iters=iters)
            check(np.array_equal(res.scores.view(np.int32), want.view(np.int32)),
                  f"{name}: serial_pagerank at {iters} iterations, bit for bit")


def serve_chaos_on_card(dev) -> None:
    """``benchmarks/serve_chaos.py``'s streams and fault plans at their
    ``BENCH_smoke.json`` sizes, on the card: the containment counters
    (and the cc row's whole metric fragment) equal to that file's."""
    from repro_torch.data.graphs import graph_request_stream
    from repro_torch.obs.metrics import derived_fragment
    from repro_torch.serve import FaultPlan, GraphRequest, GraphServeEngine

    full = ("completed", "failed", "retried", "quarantined", "degraded",
            "bisections", "wave_runs")

    def serve(stream, plan=None):
        eng = GraphServeEngine(device=dev, max_requests=8, fault_plan=plan,
                               max_retries=2)
        for i, g in enumerate(stream):
            eng.submit(GraphRequest(uid=i, **g))
        eng.run()
        return eng

    def health(eng, keys):
        h = eng.health_records[-1]
        return ";".join(f"{k}={getattr(h, k)}" for k in keys)

    out = {}
    for row, r, kind, seed, plan_seed, p in (
            ("", 16, "cc", 29, 31, (0.08, 0.12, 0.04)),
            ("sssp_", 8, "sssp", 37, 40, (0.2, 0.2, 0.12)),
            ("pagerank_", 8, "pagerank", 43, 44, (0.2, 0.2, 0.12))):
        stream = graph_request_stream(r, kind=kind, family="random", seed=seed)
        clean = serve(stream)
        got = health(clean, ("completed", "failed", "wave_runs")) + f";waves={clean.waves}"
        want = bench_counters(f"serve_chaos/{row}clean/req={r}")
        check(got == want, f"serve_chaos/{row}clean on the card: {got}, want {want}")
        plan = FaultPlan.random(plan_seed, range(r), p_poison=p[0], p_transient=p[1],
                                max_transient=2, p_nonconverge=p[2])
        if kind == "cc":  # an OOM on the first wave's own bucket, as there
            probe = GraphServeEngine(max_requests=8, device=dev)
            first_cap, _ = probe._wave_caps(
                [GraphRequest(uid=i, **g) for i, g in enumerate(stream)][:8])
            plan = FaultPlan(poison_uids=plan.poison_uids,
                             transient_uids=plan.transient_uids,
                             nonconverge_uids=plan.nonconverge_uids,
                             oom_node_caps=frozenset([first_cap]))
        eng = serve(stream, plan)
        got = health(eng, full)
        if kind == "cc":
            got += ";" + derived_fragment(eng.metrics.snapshot())
        want = bench_counters(f"serve_chaos/{row}faulty/req={r}")
        check(got == want, f"serve_chaos/{row}faulty on the card: {got}, want {want}")
        out[kind] = health(eng, full)
    print(f"serve_chaos on the card: {out} equal BENCH_smoke.json (clean rows too)")


def phase_serve_graphs(dev, card: str) -> dict:
    """Phase 13: graph serving through ``GraphServeEngine`` on the card.
    Returns the hand kernels' launches of the phase's served streams and
    the report rows."""
    import torch

    from repro_torch.data.graphs import graph_request_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    totals = {name: 0 for name in launch_counts}
    rows = []
    pagerank_waves = {}
    for label, kind, family, knobs in SERVE_GRAPH_STREAMS:
        stream = graph_request_stream(SERVE_GRAPH_REQUESTS, kind=kind, family=family,
                                      seed=SERVE_GRAPH_SEED)
        checked = stream[:SERVE_GRAPH_CHECKED]
        serve_requests(checked, dev, **knobs)  # warm-up
        batched = {}
        for budget, caps in SERVE_GRAPH_BUDGETS:
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng, done, wave_s = serve_requests(stream, dev, **knobs, **caps)
            secs = time.perf_counter() - t0
            counts = dict(launch_counts)
            for k in totals:
                totals[k] += counts[k]
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            recs = eng.wave_records
            hand = sum(counts.values())
            if kind in ("cc", "forest", "analytics"):
                rounds = sum(r.rounds for r in recs)
                check(counts["edge_hook.sv2"] == rounds == counts["edge_hook.sv3"],
                      f"serve_graphs {label} {budget}: edge_hook twice a CC round "
                      f"({counts}, {rounds} rounds)")
            spl = knobs.get("rank_engine") == "splitter"
            if kind == "analytics":
                pj, agg = counts["pointer_jump"], counts["splitter_aggregate"]
                check((pj > 0 and agg == eng.waves) if spl else (pj == agg == 0),
                      f"serve_graphs {label} {budget}: pointer_jump {pj}, "
                      f"splitter_aggregate {agg} launches in {eng.waves} waves")
            if kind == "pagerank":
                want = (1 + eng.pagerank_iters) * eng.waves
                check(counts["ordered_fold"] == want,
                      f"serve_graphs {label} {budget}: ordered_fold launched "
                      f"{counts['ordered_fold']} times, want {want}")
                pagerank_waves[budget] = (eng.waves, counts["ordered_fold"])
            batched[budget] = done
            extra = ""
            if kind == "sssp":
                extra = f" max_src_cap={max(r.src_cap for r in recs)}"
            if kind == "pagerank":
                hub = max(2 * (r.edge_cap - r.num_edges) for r in recs)
                extra = f" pad_hub_slots_max={hub}"
            row = dict(label=label, budget=budget, requests=len(stream),
                       waves=eng.waves, secs=secs,
                       rps=len(stream) / secs, wave_ms=median(wave_s) * 1e3,
                       launches_per_wave=hand / eng.waves, peak_gb=peak_gb)
            rows.append(row)
            print(f"serve_graphs {label} {budget}: requests={len(stream)} "
                  f"waves={eng.waves} req_per_wave={eng.requests_per_wave} "
                  f"buckets={eng.bucket_compiles} node_cap_max="
                  f"{max(r.node_cap for r in recs)} edge_cap_max="
                  f"{max(r.edge_cap for r in recs)}{extra} "
                  f"node_waste={eng.node_pad_waste} edge_waste={eng.edge_pad_waste} "
                  f"wall_s={secs} requests_per_s={row['rps']} "
                  f"median_wave_ms={row['wave_ms']} max_wave_ms={max(wave_s) * 1e3} "
                  f"hand_launches_per_wave={row['launches_per_wave']} "
                  f"launches={ {k: c for k, c in counts.items() if c} } "
                  f"peak_memory_gb={peak_gb} [{card}]")
            del eng, done
        # The first SERVE_GRAPH_CHECKED requests: solo on the card, and
        # batched by the port on the CPU, bit-equal to both budgets' runs.
        t0 = time.perf_counter()
        _, solo, _ = serve_requests(checked, dev, max_requests=1, **knobs)
        _, on_cpu, _ = serve_requests(checked, "cpu", **knobs)
        for uid in range(len(checked)):
            for name, other in (("solo on the card", solo), ("on the CPU", on_cpu)):
                for budget, done in batched.items():
                    check(same_result(done[uid].result, other[uid].result),
                          f"serve_graphs {label} request {uid}: {budget} batch "
                          f"equals {name}")
        iters = None
        if kind == "pagerank":
            from repro_torch.core import pagerank_iter_bound

            iters = pagerank_iter_bound()
        check_served(label, kind, checked, batched["default"], iters)
        print(f"serve_graphs {label}: {len(checked)} requests bit-equal solo on the "
              f"card, on the CPU and in both budgets, and held to their oracle "
              f"(host_s={time.perf_counter() - t0})")
        del batched, solo, on_cpu
        torch.cuda.empty_cache()
    for fam in ("edge_hook.sv2", "ordered_fold", "pointer_jump", "splitter_aggregate"):
        check(totals[fam] > 0, f"serve_graphs: {fam} launched on the serving path")
    # One wide wave of each stream traced (the serve.wave.* spans), and
    # the idle share of one wide wave of each of pagerank and analytics.
    wide = dict(SERVE_GRAPH_BUDGETS)["wide"]
    for label, kind, family, knobs in SERVE_GRAPH_STREAMS:
        stream = graph_request_stream(wide["max_requests"], kind=kind, family=family,
                                      seed=SERVE_GRAPH_SEED)
        spans, secs = wall_s(lambda: traced(
            lambda: serve_requests(stream, dev, **knobs, **wide)))
        print(f"serve_graphs {label} one wide wave traced: wall_ms={secs * 1e3} "
              + " ".join(f"{k}_ms={spans.get(k, 0.0)}" for k in (
                  "serve.wave.pack", "serve.wave.engine", "serve.wave.unpack"))
              + f" [{card}]")
        if label not in ("pagerank", "analytics-wylie"):
            continue

        def prepare(stream=stream, knobs=knobs):
            from repro_torch.serve import GraphRequest, GraphServeEngine

            eng = GraphServeEngine(device=dev, **knobs, **wide)
            for i, g in enumerate(stream):
                eng.submit(GraphRequest(uid=i, **g))
            prepare.eng = eng
            return eng.run

        wall_ms, busy_ms, events, top, idle = device_share(prepare=prepare, top=5)
        (rec,) = prepare.eng.wave_records
        print(f"serve_graphs {label} one wide wave profiled: requests={rec.requests} "
              f"node_cap={rec.node_cap} edge_cap={rec.edge_cap} "
              f"pad_hub_slots={2 * (rec.edge_cap - rec.num_edges)} wall_ms={wall_ms} "
              f"device_busy_ms={busy_ms} device_events={events} "
              f"device_idle_share={idle} top={top} [{card}]")
        rows.append(dict(label=label, budget="wide, one wave", idle=idle))
    serve_chaos_on_card(dev)
    secs = time.perf_counter() - t_phase
    print(f"phase 13 graph serving: s={secs} pagerank waves and ordered_fold "
          f"launches={pagerank_waves}")
    return {"launches": totals, "rows": rows, "secs": secs}


def multidev_dev1_rows(mesh) -> dict:
    """``benchmarks/multidev_scaling.py``'s derived strings for one
    device at the smoke size (n = 100), through the sharded engines on
    ``mesh``: ``{row name: derived}``."""
    from repro_torch.core.list_ranking import select_splitters
    from repro_torch.data.graphs import random_succ
    from repro_torch.distributed import (
        cc_exchange_words_per_round,
        rank_exchange_words,
        sharded_frontier_shiloach_vishkin,
        sharded_random_splitter_rank,
        sharded_shiloach_vishkin,
    )
    from repro_torch.ops.kiss import random_graph

    n, d = SHARDED_DEV1_N, mesh.size
    edges = random_graph(n, 4.0 / n, seed=1)
    succ = random_succ(n, seed=0)
    p = min(512, n)
    spl = select_splitters(n, p, seed=0)
    _, rounds = sharded_shiloach_vishkin(edges[:, 0], edges[:, 1], n, mesh=mesh)
    out = {f"cc_sharded_dev{d}": (
        f"rounds={int(rounds)};"
        f"exKiB/round={cc_exchange_words_per_round(n) * 4 / 1024:.1f};"
        f"edges/dev={2 * len(edges) // d}")}
    _, _, st = sharded_shiloach_vishkin(
        edges[:, 0], edges[:, 1], n, mesh=mesh, exchange="sparse",
        with_stats=True)
    w = cc_exchange_words_per_round(n, stats=st)
    out[f"cc_sharded_sparse_dev{d}"] = (
        f"capacity={st.capacity};wordsR1={int(w[0])};wordsLast={int(w[-1])};"
        f"denseWords={3 * n}")
    _, _, stf = sharded_frontier_shiloach_vishkin(
        edges[:, 0], edges[:, 1], n, mesh=mesh, min_bucket=64, with_stats=True)
    out[f"cc_sharded_frontier_dev{d}"] = (
        f"rounds={stf.rounds};edgesTouched/dev={stf.edges_touched};"
        f"denseTouched/dev={2 * (-(-stf.m2 // d)) * stf.rounds};"
        f"levels={len(stf.levels)};wordsLast={int(stf.words_per_round[-1])}")
    sharded_random_splitter_rank(succ, splitters=spl, mesh=mesh)
    out[f"rank_sharded_dev{d}"] = (
        f"exKiB={rank_exchange_words(n, p, d) * 4 / 1024:.1f};"
        f"lanes/dev={-(-p // d)}")
    return out


def nccl_share(fn) -> tuple:
    """One ``torch.profiler`` run of ``fn``: its idle share and the share
    of the card's busy time in NCCL kernels (a kernel whose name holds
    "nccl"), with the NCCL kernels' count and milliseconds."""
    wall_ms, busy_ms, events, top, idle = device_share(fn, top=10_000)
    nccl = [(k, ms) for k, ms in top if "nccl" in k.lower()]
    nccl_ms = sum(ms for _, ms in nccl)
    return idle, nccl_ms / busy_ms, len(nccl), nccl_ms, busy_ms, events


def phase_sharded(dev, card: str, list_single_s: float) -> dict:
    """Phase 14: the sharded graph engine over NCCL at world size 1, at
    phases 3-4's full sizes. Returns the hand kernels' launches of its
    checked runs and the report rows; the process group is destroyed on
    the way out, whatever happens."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import (
        connected_components,
        dedup_edges,
        list_rank,
        shiloach_vishkin,
        tree_analytics,
    )
    from repro_torch.distributed import graph_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.pointer_jump.ops import SHARED_LIMIT, default_iters
    from repro_torch.ops.kiss import random_linked_list
    from repro_torch.trees import tour_splitters

    t_phase = time.perf_counter()
    totals = {name: 0 for name in launch_counts}
    rows = []
    # An in-memory store: one rank needs no rendezvous and no network.
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = graph_mesh(1)
        check(dist.get_backend() == "nccl" and mesh.device.type == "cuda",
              f"phase 14 runs NCCL on the card ({dist.get_backend()}, "
              f"{mesh.device})")

        def counted(fn):
            """``fn()`` with the launches counted from 0, added to the
            phase's totals; returns ``(result, seconds, launches)``."""
            reset_launch_counts()
            out, secs = wall_s(fn)
            counts = dict(launch_counts)
            for k in totals:
                totals[k] += counts[k]
            return out, secs, counts

        def timed(fn):
            """Median seconds of E2E_SAMPLES calls after a warm-up."""
            fn()
            return median([wall_s(fn)[1] for _ in range(E2E_SAMPLES)])

        # The dev1 rows of BENCH_smoke.json, character for character.
        for name, got in multidev_dev1_rows(mesh).items():
            want = bench_counters(name)
            check(got == want, f"sharded {name}: {got!r} == BENCH_smoke's {want!r}")
            print(f"sharded {name} n={SHARDED_DEV1_N}: {got} (BENCH_smoke.json's)")

        for name, edges, n in cc_graphs():
            t0 = time.perf_counter()
            du, dv = dedup_edges(edges[:, 0], edges[:, 1])
            dedup_s = time.perf_counter() - t0
            del edges
            def single():
                return shiloach_vishkin(du, dv, n, dedup=False, device=dev)

            want_l, want_r = single()
            single_s = timed(single)
            calls = {
                "sharded_frontier": dict(mesh=mesh),
                "dense": dict(mesh=mesh, engine="dense"),
                "dense_sparse": dict(mesh=mesh, engine="dense",
                                     exchange="sparse"),
            }
            for label, kw in calls.items():
                (labels, rounds, st), _, counts = counted(
                    lambda kw=kw: connected_components(
                        du, dv, n, dedup=False, with_stats=True, **kw))
                check(rounds == want_r and torch.equal(labels, want_l),
                      f"sharded {name} {label}: labels and rounds equal the "
                      f"single-device dense engine's")
                for mode in ("edge_hook.sv2", "edge_hook.sv3"):
                    check(counts[mode] == rounds,
                          f"sharded {name} {label}: {mode} launched "
                          f"{counts[mode]} times in {rounds} rounds")
                secs = timed(lambda kw=kw: connected_components(
                    du, dv, n, dedup=False, **kw))
                extra = (f"levels={st.levels} edges_touched={st.edges_touched} "
                         f"capacities={st.capacities}"
                         if label == "sharded_frontier" else
                         f"capacity={st.capacity}")
                print(f"sharded {name} {label} ({st.exchange} exchange): n={n} "
                      f"m2={2 * len(du)} rounds={rounds} wall_s={secs} "
                      f"single_device_dense_s={single_s} "
                      f"words_per_round={st.words_per_round.tolist()} "
                      f"frontier_per_round={st.frontier_per_round.tolist()} "
                      f"{extra} [{card}]")
                rows.append((f"cc {name} {label}", secs, single_s))
            if name == "random":
                idle, share, k, nccl_ms, busy_ms, events = nccl_share(
                    lambda: connected_components(du, dv, n, dedup=False,
                                                 mesh=mesh))
                print(f"sharded {name} sharded_frontier profiled: "
                      f"device_idle_share={idle} nccl_share_of_busy={share} "
                      f"nccl_kernels={k} nccl_ms={nccl_ms} busy_ms={busy_ms} "
                      f"device_events={events} [{card}]")
                rows.append(("nccl share, cc random sharded_frontier", share, idle))
            if name == "giant_dust":
                want_h = shiloach_vishkin(du, dv, n, dedup=False,
                                          record_hooks=True, device=dev)[2]
                (labels, rounds, hooks), secs, counts = counted(
                    lambda: connected_components(du, dv, n, dedup=False,
                                                 mesh=mesh, record_hooks=True))
                check(rounds == want_r and torch.equal(labels, want_l)
                      and all(torch.equal(x, y) for x, y in zip(hooks, want_h)),
                      f"sharded {name} record_hooks: labels, rounds and hook "
                      "forest equal the single-device dense engine's")
                check(counts["edge_hook.sv2"] == rounds,
                      f"sharded {name} record_hooks: edge_hook twice a round")
                print(f"sharded {name} record_hooks: forest bit-equal, "
                      f"wall_s={secs} (one call) [{card}]")
            print(f"sharded {name}: dedup_edges once, host_s={dedup_s}")
            del du, dv, want_l
            torch.cuda.empty_cache()

        # List ranking on phase 4's list, against the single-device engine.
        succ = random_linked_list(LIST_N, seed=0)
        want = list_rank(succ, device=dev)
        list_rank(random_linked_list(PROFILE_LIST_N, seed=0), mesh=mesh)  # warm-up
        secs = []
        for i in range(E2E_SAMPLES):
            (rank, st), s, counts = counted(
                lambda: list_rank(succ, mesh=mesh, with_stats=True))
            secs.append(s)
            if i == 0:
                check(torch.equal(rank, want),
                      "sharded list_rank: ranks equal the single-device engine's")
                check(counts["pointer_jump"] == 1
                      and counts["splitter_aggregate"] == 1,
                      f"sharded list_rank: one pointer_jump and one "
                      f"splitter_aggregate launch, got {counts}")
        print(f"sharded list_rank n={LIST_N} p={len(st.splitters)} "
              f"walk_steps={st.walk_steps} wall_s={median(secs)} samples={secs} "
              f"single_device_s={list_single_s} (phase 4) words="
              f"{2 * LIST_N + 2 * len(st.splitters)} [{card}]")
        rows.append(("list_rank", median(secs), list_single_s))
        del succ, want, rank

        # Tree analytics on phase 12's molecule-batch forest: the sharded
        # CC engine and the sharded splitter ranker end to end.
        families, _ = tree_families()
        n, edges = families["molecule-batch"]
        want, single_s = wall_s(lambda: tree_analytics(
            edges[:, 0], edges[:, 1], n, rank_engine="splitter", device=dev))
        ta, secs, counts = counted(lambda: tree_analytics(
            edges[:, 0], edges[:, 1], n, mesh=mesh))
        for k in ("parent", "depth", "subtree_size", "preorder", "postorder"):
            check(torch.equal(getattr(ta.computations, k),
                              getattr(want.computations, k)),
                  f"sharded tree_analytics: {k} equals the single-device run")
        rounds = ta.forest.rounds
        p = len(tour_splitters(ta.tour))
        want_pj = 1 if p <= SHARED_LIMIT else default_iters(p)
        check(counts["edge_hook.sv2"] == rounds == counts["edge_hook.sv3"]
              and counts["pointer_jump"] == want_pj
              and counts["splitter_aggregate"] == 1,
              f"sharded tree_analytics: edge_hook twice a round, {want_pj} "
              f"pointer_jump and one splitter_aggregate launch, got {counts}")
        print(f"sharded tree_analytics molecule-batch n={n} cc_rounds={rounds} "
              f"p={p}: every field equal, wall_s={secs} (one call) "
              f"single_device_splitter_s={single_s} (one call) [{card}]")
        rows.append(("tree_analytics molecule-batch", secs, single_s))
    finally:
        dist.destroy_process_group()
    return {"launches": totals, "rows": rows,
            "secs": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# Phase 15: the rest of GNN and RecSys inference at full width.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def index_add_sums():
    """Every float segment sum of ``ops/segment.py`` through a plain
    ``index_add_`` (float32 accumulation) in place of the kernel, for the
    independent forward a cell is held to."""
    import torch

    from repro_torch.ops import segment

    def by_index_add(data, ids, n, **_):
        keep = torch.where((ids >= 0) & (ids < n), ids.long(), n)
        out = torch.zeros((n + 1, *data.shape[1:]), dtype=torch.float32,
                          device=data.device)
        return out.index_add_(0, keep, data.float())[:n].to(data.dtype)

    real = segment.segment_sum_sorted
    segment.segment_sum_sorted = by_index_add
    try:
        yield
    finally:
        segment.segment_sum_sorted = real


def check_close(name, got, want, rtol: float = GNN_TOL):
    """``got`` within ``rtol`` of ``want`` elementwise, with an atol of
    ``rtol`` times the smaller of 1 and ``want``'s rms; both finite."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{name}: finite values")
    diff = (got.double() - want.double()).abs()
    atol = rtol * min(1.0, float(want.double().square().mean().sqrt()))
    over = int((diff > atol + rtol * want.double().abs()).sum())
    scale = float(want.abs().max())
    print(f"{name}: max_abs_diff={float(diff.max())} max_abs={scale} "
          f"normwise_rel={float(diff.max()) / max(scale, 1e-30)} "
          f"rms={float(want.double().square().mean().sqrt())} rtol={rtol} atol={atol} "
          f"over_tol={over} of {want.numel()}")
    check(over == 0, f"{name}: within rtol {rtol}, atol {atol}")


def slice11_cell(label, fwd, graph_m, layers, want_launches, check_fn, profile,
                 rows=None):
    """One phase-15 cell: ``fwd()`` warmed up, then three timed calls
    (median; launches counted from 0 in the first), peak memory, the
    first call's output held by ``check_fn(label, got, want)`` to the
    same forward with ``index_add_`` sums, and where ``profile`` the idle
    share and top device kernels of one profiled call. The rate is
    ``layers * graph_m`` edges/s, or ``rows``/s where given."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    with torch.inference_mode():
        fwd()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        got, first = wall_s(fwd)
        launches = launch_counts["segment_sum"]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == want_launches,
              f"{label}: segment_sum launched {launches} times in one forward, "
              f"want {want_launches}")
        secs = [first] + [wall_s(fwd)[1] for _ in range(E2E_SAMPLES - 1)]
        with index_add_sums():
            want = fwd()
        check(launch_counts["segment_sum"] == launches * E2E_SAMPLES,
              f"{label}: the index_add_ forward launched no kernel")
        pairs = (zip(got, want) if isinstance(got, tuple) else [(got, want)])
        for i, (g, w) in enumerate(pairs):
            check_fn(f"{label} output {i} vs index_add_ forward", g, w)
        del got, want
        idle = None
        if profile:
            wall_ms, device_ms, events, ranked, idle = device_share(fwd, top=8)
            print(f"slice11 {label} profiled: wall_ms={wall_ms} device_busy_ms={device_ms} "
                  f"device_events={events} device_idle_share={idle}")
            for kname, ms in ranked:
                print(f"slice11 {label} device time by kernel: {ms:.3f} ms {kname[:110]}")
    med = median(secs)
    rate, unit = ((rows / med, "rows_per_s") if rows is not None
                  else (layers * graph_m / med, "edges_per_s"))
    print(f"slice11 {label}: wall_ms={med * 1e3} samples_ms={[x * 1e3 for x in secs]} "
          f"{unit}={rate} segment_sum_launches={launches} peak_memory_gb={peak_gb} "
          f"[{card_line()}]")
    return {"label": label, "secs": med, "rate": rate, "unit": unit, "peak_gb": peak_gb,
            "idle": idle, "launches": launches}


def slice11_graph(g: dict, dev, keys=("node_feats", "src", "dst", "graph_ids")) -> dict:
    import torch

    out = {k: torch.from_numpy(np.ascontiguousarray(g[k])).to(dev) for k in keys}
    out["num_graphs"] = int(g["num_graphs"])
    return out


def fixed_rotation(dev):
    """A fixed proper rotation (the port's ``so3._rand_rotation`` of
    ``default_rng(11)``), float32 on ``dev``."""
    import torch

    from repro_torch.models.gnn.so3 import _rand_rotation

    return torch.from_numpy(_rand_rotation(np.random.default_rng(11))).float().to(dev)


def rel_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def geometric_rotation(label, fwd, graph, dev, egnn: bool):
    """A fixed rotation of the positions: the readout (energies) unchanged
    within ROTATION_RTOL of its largest value, EGNN's positions rotated
    within ROTATION_RTOL of their largest. MACE is held on the graph
    without its self-loop edges: the reference's Y_l of a zero vector
    (l = 2: (0, 0, -c, 0, 0)) does not turn with the frame, so a self-loop
    adds a part that does not rotate; its effect on the whole graph is
    printed, not checked."""
    import torch

    rot = fixed_rotation(dev)
    with torch.inference_mode():
        graphs = [("with self-loops", graph)]
        if not egnn:
            keep = graph["src"] != graph["dst"]
            graphs.append(("without self-loops", dict(graph, src=graph["src"][keep],
                                                       dst=graph["dst"][keep])))
        for what, g in graphs:
            base = fwd(g)
            turned = fwd(dict(g, positions=g["positions"] @ rot.T))
            if egnn:
                e_read = rel_err(turned[0], base[0])
                e_pos = rel_err(turned[1], base[1] @ rot.T)
                print(f"slice11 {label} rotation {what}: readout rel_err={e_read} "
                      f"positions rel_err={e_pos} rtol={ROTATION_RTOL}")
                check(e_read <= ROTATION_RTOL and e_pos <= ROTATION_RTOL,
                      f"{label}: readout invariant, positions rotate")
            else:
                e = rel_err(turned, base)
                checked = what == "without self-loops"
                print(f"slice11 {label} rotation {what} (m={int(g['src'].shape[0])}): "
                      f"energies rel_err={e} rtol={ROTATION_RTOL} "
                      f"{'checked' if checked else 'not checked'}")
                check(not checked or e <= ROTATION_RTOL, f"{label}: energies invariant")


def slice11_gnn_cells(dev, ogb: dict, minibatch: dict, molecules: dict) -> list:
    """Phase 15's GNN cells: GCN and SAGE on ogb_products, SAGE on
    minibatch_lg, and PNA, EGNN and MACE on molecule_batch(128) and
    molecule_batch(4096)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.models.gnn import extra

    gen = torch.Generator(dev)
    cells = []
    graph = slice11_graph(ogb, dev)
    m = int(graph["src"].shape[0])
    for name, cfg_cls, init, fwd, per_layer in (
            ("gcn", extra.GCNConfig, extra.gcn_init, extra.gcn_forward, 1),
            ("sage", extra.SAGEConfig, extra.sage_init, extra.sage_forward, 1)):
        cfg = cfg_cls(in_dim=GNN_D, num_classes=GNN_CLASSES)
        params = init(cfg, generator=gen.manual_seed(0), device=dev)
        cells.append(slice11_cell(
            f"{name} {GNN_SHAPE}", lambda: fwd(params, cfg, graph), m, cfg.num_layers,
            per_layer * cfg.num_layers, check_logits, profile=True))
        del params
        torch.cuda.empty_cache()
    del graph
    graph = slice11_graph(minibatch, dev)
    cfg = extra.SAGEConfig(in_dim=MINIBATCH_LG["d_feat"],
                           num_classes=MINIBATCH_LG["num_classes"])
    params = extra.sage_init(cfg, generator=gen.manual_seed(0), device=dev)
    cells.append(slice11_cell(
        "sage minibatch_lg", lambda: extra.sage_forward(params, cfg, graph),
        int(graph["src"].shape[0]), cfg.num_layers, cfg.num_layers, check_logits,
        profile=False))
    del graph, params
    for batch, mol in molecules.items():
        graph = slice11_graph(mol, dev, ("node_feats", "src", "dst", "graph_ids",
                                         "positions", "species"))
        m = int(graph["src"].shape[0])
        big = batch == MOLECULE_BIG
        cfg = extra.PNAConfig(in_dim=mol["node_feats"].shape[1],
                              num_classes=max(GNN_SHAPES["molecule"]["classes"], 2))
        params = extra.pna_init(cfg, generator=gen.manual_seed(0), device=dev)
        cells.append(slice11_cell(
            f"pna molecule({batch})", lambda: extra.pna_forward(params, cfg, graph), m,
            cfg.num_layers, 2 * cfg.num_layers, check_close, profile=big))
        arch = get_arch("egnn")
        cfg = arch.config_for("molecule")
        params = arch.module.init_params(cfg, generator=gen.manual_seed(0), device=dev)
        for layer in params["layers"]:  # the EGNN authors' init of this layer
            layer["coord_mlp"][-1]["w"].mul_(EGNN_COORD_GAIN)
        cells.append(slice11_cell(
            f"egnn molecule({batch})", lambda: arch.module.forward(params, cfg, graph),
            m, cfg.num_layers, 2 + 2 * cfg.num_layers, check_close, profile=big))
        if big:
            geometric_rotation(f"egnn molecule({batch})",
                               lambda g: arch.module.forward(params, cfg, g), graph, dev,
                               egnn=True)
        arch = get_arch("mace")
        cfg = arch.config_for("molecule")
        params = arch.module.init_params(cfg, generator=gen.manual_seed(0), device=dev)
        cells.append(slice11_cell(
            f"mace molecule({batch})", lambda: arch.module.forward(params, cfg, graph),
            m, cfg.num_layers, (cfg.l_max + 1) * cfg.num_layers + 1, check_close,
            profile=big))
        if big:
            geometric_rotation(f"mace molecule({batch})",
                               lambda g: arch.module.forward(params, cfg, g), graph, dev,
                               egnn=False)
        del graph, params
        torch.cuda.empty_cache()
    return cells


def xdeepfm_one_shot(params, cfg, batch):
    """xDeepFM's logits with the reference's one-shot CIN einsum in place
    of the chunked layers (the (B, H, m, D) products made at once)."""
    import torch

    from repro_torch.models.recsys import xdeepfm

    orig = xdeepfm.cin_layer
    xdeepfm.cin_layer = lambda xk, x0, w, **_: torch.einsum("bhd,bmd,ohm->bod", xk, x0, w)
    try:
        return xdeepfm.forward(params, cfg, batch)
    finally:
        xdeepfm.cin_layer = orig


def retrieval_f64(params, cfg, batch):
    """``serve_retrieval``'s scores computed in float64 from the same
    parameters."""
    import torch

    from repro_torch.models.recsys import xdeepfm

    rows = xdeepfm._rows(params, cfg, batch)
    emb = params["table"].index_select(0, rows.reshape(-1)).double().reshape(1, -1)
    h = emb
    for layer in params["mlp"]:
        h = torch.relu(h @ layer["w"].double() + layer["b"].double())
    user = h @ params["retrieval_proj"].double()
    return (user @ params["cand_embed"].double().T)[0]


def slice11_recsys(dev) -> list:
    """Phase 15's RecSys cells: xDeepFM ``serve_step`` at 512 and 262,144
    rows and ``serve_retrieval`` at one row over 10^6 candidates, and
    ``embedding_bag`` (sum, mean) over the model's table."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import recsys_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.ops.embedding_bag import embedding_bag

    cfg = get_arch("xdeepfm").config
    t0 = time.perf_counter()
    params = xdeepfm.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                 device=dev)
    torch.cuda.synchronize()
    print(f"xdeepfm: params={sum(p.numel() for p in params.parameters())} "
          f"init_s={time.perf_counter() - t0} memory_gb={torch.cuda.memory_allocated() / 1e9}")
    cells, scores = [], {}
    for shape, rows in XDEEPFM_SERVE:
        t0 = time.perf_counter()
        batch = {"sparse_ids": torch.from_numpy(recsys_batch(
            rows, cfg.n_fields, cfg.vocab_per_field, seed=0)["sparse_ids"]).to(dev)}
        print(f"xdeepfm {shape}: recsys_batch({rows}) host_s={time.perf_counter() - t0}")
        with torch.inference_mode():
            xdeepfm.serve_step(params, cfg, batch)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            out, first = wall_s(lambda: xdeepfm.serve_step(params, cfg, batch))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            secs = [first] + [wall_s(lambda: xdeepfm.serve_step(params, cfg, batch))[1]
                              for _ in range(E2E_SAMPLES - 1)]
            check(bool(((out >= 0) & (out <= 1)).all()), f"xdeepfm {shape}: scores in [0, 1]")
            if rows == XDEEPFM_SERVE[0][1]:
                check_close(f"xdeepfm {shape} chunked CIN vs one-shot einsum logits",
                            xdeepfm.forward(params, cfg, batch),
                            xdeepfm_one_shot(params, cfg, batch))
            scores[shape] = out
        med = median(secs)
        print(f"slice11 xdeepfm {shape}: rows={rows} wall_ms={med * 1e3} "
              f"samples_ms={[x * 1e3 for x in secs]} rows_per_s={rows / med} "
              f"peak_memory_gb={peak_gb} [{card_line()}]")
        cells.append({"label": f"xdeepfm {shape}", "secs": med, "rate": rows / med,
                      "unit": "rows_per_s", "peak_gb": peak_gb, "idle": None, "launches": 0})
    # The bulk batch's first 512 rows are the p99 batch (one KISS draw
    # order): the same scores through other chunks.
    small = XDEEPFM_SERVE[0][1]
    check_close("xdeepfm serve_bulk rows 0..511 vs serve_p99",
                scores["serve_bulk"][:small], scores["serve_p99"])
    del scores
    one = {"sparse_ids": torch.from_numpy(recsys_batch(
        1, cfg.n_fields, cfg.vocab_per_field, seed=1)["sparse_ids"]).to(dev)}
    with torch.inference_mode():
        xdeepfm.serve_retrieval(params, cfg, one, top_k=RETRIEVAL_TOP_K)
        torch.cuda.reset_peak_memory_stats()
        (sc, (vals, ids)), first = wall_s(
            lambda: xdeepfm.serve_retrieval(params, cfg, one, top_k=RETRIEVAL_TOP_K))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        secs = [first] + [wall_s(lambda: xdeepfm.serve_retrieval(
            params, cfg, one, top_k=RETRIEVAL_TOP_K))[1] for _ in range(E2E_SAMPLES - 1)]
        s64 = retrieval_f64(params, cfg, one)
        check_close("xdeepfm retrieval scores vs float64", sc.double(), s64)
        ranked = torch.sort(s64, descending=True).values
        gap = float(ranked[RETRIEVAL_TOP_K - 1] - ranked[RETRIEVAL_TOP_K])
        err = float((sc.double() - s64).abs().max())
        same = set(ids.tolist()) == set(torch.topk(s64, RETRIEVAL_TOP_K).indices.tolist())
        print(f"xdeepfm retrieval top {RETRIEVAL_TOP_K}: k-th minus (k+1)-th float64 "
              f"score={gap} max float32 score error={err} same ids={same}")
        check(same or gap <= 2 * err, "xdeepfm retrieval: top-k ids equal float64's "
              "wherever the k-th and (k+1)-th scores stand apart")
    med = median(secs)
    print(f"slice11 xdeepfm retrieval_cand: candidates={cfg.n_candidates} wall_ms={med * 1e3} "
          f"samples_ms={[x * 1e3 for x in secs]} candidates_per_s={cfg.n_candidates / med} "
          f"peak_memory_gb={peak_gb} [{card_line()}]")
    cells.append({"label": "xdeepfm retrieval_cand", "secs": med,
                  "rate": cfg.n_candidates / med, "unit": "candidates_per_s",
                  "peak_gb": peak_gb, "idle": None, "launches": 0})
    # embedding_bag over the table: each p99 row one bag of its 39 ids.
    ids = xdeepfm._rows(params, cfg, {"sparse_ids": torch.from_numpy(recsys_batch(
        small, cfg.n_fields, cfg.vocab_per_field, seed=0)["sparse_ids"]).to(dev)})
    flat = ids.reshape(-1)
    bags = torch.arange(small, device=dev, dtype=torch.int32).repeat_interleave(cfg.n_fields)
    offsets = torch.arange(0, flat.numel(), cfg.n_fields, device=dev)
    launched = 0
    for mode in ("sum", "mean"):
        with torch.inference_mode():
            reset_launch_counts()
            got = embedding_bag(params["table"], flat, bags, small, mode=mode,
                                indices_are_sorted=True)
            launched += launch_counts["segment_sum"]
            check(launch_counts["segment_sum"] == 1,
                  f"embedding_bag {mode}: one segment_sum launch")
            want = F.embedding_bag(flat, params["table"], offsets, mode=mode)
            err = segsum_within(f"embedding_bag {mode} (m={flat.numel()}, "
                                f"{cfg.embed_dim}) vs F.embedding_bag:", got, want,
                                cfg.n_fields)
            ms = cuda_ms(lambda: embedding_bag(params["table"], flat, bags, small,
                                               mode=mode, indices_are_sorted=True))
            lib_ms = cuda_ms(lambda: F.embedding_bag(flat, params["table"], offsets,
                                                     mode=mode))
        print(f"time embedding_bag {mode} bags={small} x {cfg.n_fields}: ms={ms} "
              f"F.embedding_bag_ms={lib_ms} max_abs_err={err} [{card_line()}]")
    cells.append({"label": "embedding_bag sum+mean (checks)", "secs": None, "rate": None,
                  "unit": None, "peak_gb": None, "idle": None, "launches": launched})
    del params
    torch.cuda.empty_cache()
    return cells


def slice11_segsum_cases(dev, minibatch: dict, molecule: dict) -> list:
    """``(name, ids, n, feat)`` of the segment sums this slice's models
    make at shapes phases 2 and 5 do not cover: EGNN, MACE and PNA on
    molecule_batch(4096), the graph readouts over its graph ids, and
    SAGE on minibatch_lg."""
    import torch

    mol_ids = torch.from_numpy(molecule["dst"]).to(dev)
    gids = torch.from_numpy(molecule["graph_ids"]).to(dev)
    mb_ids = torch.from_numpy(minibatch["dst"]).to(dev)
    n_mol, n_mb = len(molecule["graph_ids"]), len(minibatch["graph_ids"])
    mol = f"molecule({MOLECULE_BIG})"
    return [
        (f"{mol} egnn degree (m, 1)", mol_ids, n_mol, (1,)),
        (f"{mol} egnn coordinates (m, 3)", mol_ids, n_mol, (3,)),
        (f"{mol} egnn messages (m, 64)", mol_ids, n_mol, (64,)),
        (f"{mol} pna layer 1 sums (m, 16)", mol_ids, n_mol, (16,)),
        (f"{mol} pna layer 2 sums (m, 32)", mol_ids, n_mol, (32,)),
        (f"{mol} mace A l=0 (m, 128, 1)", mol_ids, n_mol, (128, 1)),
        (f"{mol} mace A l=1 (m, 128, 3)", mol_ids, n_mol, (128, 3)),
        (f"{mol} mace A l=2 (m, 128, 5)", mol_ids, n_mol, (128, 5)),
        (f"{mol} egnn readout (nodes, 1) over graph ids", gids, MOLECULE_BIG, (1,)),
        (f"{mol} mace energy readout (nodes,) over graph ids", gids, MOLECULE_BIG, ()),
        ("minibatch_lg sage layer 1 (m, 602)", mb_ids, n_mb, (MINIBATCH_LG["d_feat"],)),
        ("minibatch_lg sage layer 2 (m, 64)", mb_ids, n_mb, (64,)),
    ]


def phase_segment_sum_slice11(dev, cases) -> None:
    """Phase 2, ``segment_sum`` at this slice's shapes: the kernel against
    its plain version (float32, rtol 2e-5) and two calls bit-equal."""
    import torch

    gen = torch.Generator(dev).manual_seed(5)
    for name, ids, n, feat in cases:
        data = torch.randn((ids.shape[0], *feat), device=dev, generator=gen)
        segsum_check(name, data, ids, n)
        segsum_bit_equal(name, data, ids, n)
        del data


def phase_slice11(dev, ogb: dict, minibatch: dict, molecules: dict, cases) -> dict:
    """Phase 15: ``segment_sum``'s times at this slice's shapes, then the
    GNN and RecSys cells. Returns the cells, the segment_sum times and
    the phase's seconds."""
    import torch

    t_phase = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(6)
    times = []
    for name, ids, n, feat in cases:
        data = torch.randn((ids.shape[0], *feat), device=dev, generator=gen)
        times.append((name, time_segsum(dev, name, data, ids, n)))
        del data
    torch.cuda.empty_cache()
    cells = slice11_gnn_cells(dev, ogb, minibatch, molecules)
    cells += slice11_recsys(dev)
    secs = time.perf_counter() - t_phase
    print(f"phase 15 gnn and recsys inference: s={secs}")
    return {"cells": cells, "times": times, "secs": secs}


# ---------------------------------------------------------------------------
# Phase 16: MoE, MLA and the MTP head (mixtral-8x7b, deepseek-v3)
# ---------------------------------------------------------------------------


def rows_within(label, got, want, tol: float) -> float:
    """Each row of ``got`` within ``tol`` of ``want``'s in norm:
    ``||got_i - want_i|| <= tol * ||want_i||``, ``got`` finite. Prints the
    worst row's ratio, the normwise error and, beside, how many elements
    pass ``|got - want| > tol * rms(want) + tol * |want|``; returns the
    largest |err|."""
    import torch

    g, w = got.float(), want.float()
    check(g.shape == w.shape, f"{label}: shapes {tuple(g.shape)} vs {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{label}: finite output")
    diff = g - w
    ratio = diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    rms = float(w.square().mean().sqrt())
    elem_over = int((diff.abs() > tol * rms + tol * w.abs()).sum())
    err = float(diff.abs().max())
    print(f"{label}: worst_row_rel_err={float(ratio.max())} "
          f"normwise_rel_err={float(diff.norm() / w.norm())} max_abs_err={err} "
          f"mean_abs_err={float(diff.abs().mean())} rms_want={rms} tol={tol} "
          f"elements_past_{tol}_x_(rms+|want|)={elem_over} of {w.numel()}")
    check(float(ratio.max()) <= tol, f"{label}: every row within {tol} in norm")
    return err


def mla_qkv(dev, gen, s: int, heads: int = MLA_HEADS):
    """MLA's prefill operands as ``attention.py::mla_attention`` hands
    them to the kernel: q and k (B, S, H, 192) from ``torch.cat``,
    transposed; v the last 128 columns of the (B, S, H, 256) expansion of
    the latent, transposed (a strided view the kernel reads in place)."""
    import torch

    bf = torch.bfloat16
    q = torch.randn(1, s, heads, 192, device=dev, generator=gen).to(bf)
    k = torch.randn(1, s, heads, 192, device=dev, generator=gen).to(bf)
    kv = torch.randn(1, s, heads, 256, device=dev, generator=gen).to(bf)
    return q.transpose(1, 2), k.transpose(1, 2), kv[..., 128:].transpose(1, 2)


def phase_attention_mla(dev) -> float:
    """Phase 6, MLA: the kernel's (D, Dv) = (192, 128) instance against
    ``attention_ref`` on the model's layout, at deepseek-v3's prefill
    shape (heads 0-15 and 112-127: Hq = Hkv, so a slice of heads is the
    same attention) and at a ragged S; the views bit-equal to contiguous
    copies. Returns the largest max_abs_err."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(16)
    bf = str(torch.bfloat16)
    q, k, v = mla_qkv(dev, gen, MLA_S)
    out = flash_attention(q, k, v, impl="cuda")
    check(tuple(out.shape) == (1, MLA_HEADS, MLA_S, 128) and out.transpose(1, 2).is_contiguous(),
          f"(o) MLA output (1, H, S, 128) laid out as q: {tuple(out.shape)} {out.stride()}")
    errs = []
    n = MLA_CHECK_HEADS
    for heads in (slice(0, n), slice(MLA_HEADS - n, MLA_HEADS)):
        errs.append(attn_err(out[:, heads], attention_ref(q[:, heads], k[:, heads], v[:, heads]),
                             bf, f"(o) MLA B=1 H={MLA_HEADS} S={MLA_S} D=192 Dv=128 causal, "
                             f"heads {heads.start}-{heads.stop - 1}"))
    dense = flash_attention(*(x.contiguous() for x in (q, k, v)), impl="cuda")
    check(torch.equal(out, dense), "(o) MLA views and contiguous copies give the same bits")
    check(torch.equal(out, flash_attention(q, k, v, impl="cuda")),
          "(o) MLA two calls bit-equal")
    print("flash_attention (o) MLA: views bit-equal to contiguous copies; two calls bit-equal")
    del q, k, v, out, dense
    q, k, v = mla_qkv(dev, gen, MLA_RAGGED_S)
    for causal in (True, False):
        errs.append(attn_err(flash_attention(q, k, v, causal=causal, impl="cuda"),
                             attention_ref(q, k, v, causal=causal), bf,
                             f"(p) MLA ragged S={MLA_RAGGED_S} D=192 Dv=128 causal={causal}"))
    del q, k, v
    torch.cuda.empty_cache()
    return max(errs)


def combine_ids(dev, t: int, k: int):
    """The MoE combine's token ids: ``k`` rows a token, token-major."""
    import torch

    return torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(k)


def phase_segment_sum_moe(dev) -> float:
    """Phase 2, ``segment_sum`` at the MoE combines' shapes (bf16, ``top_k``
    rows a token): within phase 2's bf16 tolerance of its plain version,
    and two calls bit-equal. Returns the largest max_abs_err."""
    import torch

    gen = torch.Generator(dev).manual_seed(17)
    errs = []
    for name, t, k, d in MOE_COMBINES:
        ids = combine_ids(dev, t, k)
        data = torch.randn(t * k, d, device=dev, generator=gen).to(torch.bfloat16)
        label = f"{name} MoE combine ({t * k}, {d}) bf16, {k} rows a token"
        errs.append(segsum_check(label, data, ids, t))
        segsum_bit_equal(label, data, ids, t)
        del data, ids
    torch.cuda.empty_cache()
    return max(errs)


def sdpa_backend(q, k, v):
    """The first of PyTorch's SDPA backends (flash, cuDNN, efficient) that
    takes these inputs, or None."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError as err:
            print(f"sdpa backend {backend.name} refuses (D, Dv) = "
                  f"({q.shape[-1]}, {v.shape[-1]}): {str(err).splitlines()[0][:160]}")
    return None


def moe_kernel_times(dev, card: str) -> dict:
    """Phase 16's kernel times, before the models load: ``flash_attention``
    at MLA's prefill shape (device ms, ms per Python call, the plain
    version's, SDPA's where a backend takes Dv != D, the FLOP bound) with
    the ``torch.cat`` that writes the shared rope key into each head's
    key beside it; at mixtral's windowed prefill; ``segment_sum`` at each
    combine shape; and the sorted-vs-unsorted dispatch A/B at
    deepseek-v3's T = 4096, k = 8, E = 256."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.transformer import moe

    gen = torch.Generator(dev).manual_seed(18)
    out = {}
    q, k, v = mla_qkv(dev, gen, MLA_S)
    bound, flops, nbytes = attention_bound_ms(1, MLA_HEADS, MLA_HEADS, MLA_S, MLA_S, 192,
                                              True, None, 2, dv=128)
    ms = graph_ms(lambda: flash_attention(q, k, v, impl="cuda"))
    eager = cuda_ms(lambda: flash_attention(q, k, v, impl="cuda"), iters=20)
    plain = cuda_ms(lambda: attention_ref(q, k, v), iters=2, warmup=1)
    backend = sdpa_backend(q, k, v)
    sdpa_ms = None
    if backend is not None:
        def sdpa():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        sdpa_ms = graph_ms(sdpa)
        sdpa_err = float((sdpa().float() - flash_attention(q, k, v, impl="cuda").float())
                         .abs().max())
        print(f"sdpa {backend.name} at (D, Dv) = (192, 128): max |sdpa - kernel| = {sdpa_err}")
    k_nope = torch.randn(1, MLA_S, MLA_HEADS, 128, device=dev, generator=gen).to(torch.bfloat16)
    k_rope = torch.randn(1, MLA_S, 64, device=dev, generator=gen).to(torch.bfloat16)
    cat_ms = graph_ms(lambda: torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(1, MLA_S, MLA_HEADS, 64)], dim=-1))
    print(f"time flash_attention MLA B=1 H={MLA_HEADS} S={MLA_S} D=192 Dv=128 bf16 causal: "
          f"ms={ms} eager_ms={eager} plain_ms={plain} "
          f"sdpa_ms={sdpa_ms} ({'no backend' if backend is None else backend.name}) "
          f"bound_ms={bound} flops={flops} bytes={nbytes} share_of_bound={bound / ms} "
          f"tflops={flops / ms / 1e9}; the k_rope broadcast copy (torch.cat into "
          f"(1, S, H, 192)) ms={cat_ms} [{card}]")
    out["mla"] = (ms, plain, eager, sdpa_ms, bound)
    del q, k, v, k_nope, k_rope
    torch.cuda.empty_cache()
    mix = get_arch("mixtral-8x7b").config
    s, w = MOE_CELLS[0][2], mix.sliding_window
    qs, ks, vs = (torch.randn(1, h, s, mix.head_dim, device=dev, generator=gen)
                  .to(torch.bfloat16) for h in (mix.num_heads, mix.num_kv_heads,
                                                mix.num_kv_heads))
    wbound, wflops, _ = attention_bound_ms(1, mix.num_heads, mix.num_kv_heads, s, s,
                                           mix.head_dim, True, w, 2)
    wms = graph_ms(lambda: flash_attention(qs, ks, vs, window=w, impl="cuda"))
    print(f"time flash_attention mixtral B=1 Hq={mix.num_heads} Hkv={mix.num_kv_heads} "
          f"S={s} D={mix.head_dim} window={w} bf16 causal: ms={wms} bound_ms={wbound} "
          f"share_of_bound={wbound / wms} tflops={wflops / wms / 1e9} [{card}]")
    del qs, ks, vs
    for name, t, k_, d in MOE_COMBINES:
        ids = combine_ids(dev, t, k_)
        data = torch.randn(t * k_, d, device=dev, generator=gen).to(torch.bfloat16)
        out[name] = time_segsum(dev, f"{name} MoE combine ({t * k_}, {d}) bf16, "
                                     f"{k_} rows a token", data, ids, t)
        del data, ids
    torch.cuda.empty_cache()
    # The dispatch A/B: the same buffers by the sort and by the one-hot
    # cumulative sum (the paper's coalescing guideline); printed, no claim.
    cfg = get_arch("deepseek-v3-671b").config
    m, t = cfg.moe, MOE_COMBINES[1][1]
    tokens = torch.randn(t, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)
    router = torch.randn(cfg.d_model, m.num_experts, device=dev, generator=gen) \
        * cfg.d_model ** -0.5
    gates, eidx = moe._route(tokens, router, m)
    cap = moe._capacity(t, m, m.num_experts)
    times, bufs = {}, {}
    for dispatch in ("sorted_ep", "unsorted"):
        md = dataclasses.replace(m, dispatch=dispatch)
        bufs[dispatch] = moe._dispatch(tokens, gates, eidx, md, m.num_experts, cap)[0]
        times[dispatch] = cuda_ms(lambda: moe._dispatch(tokens, gates, eidx, md,
                                                        m.num_experts, cap), iters=20)
    check(torch.equal(bufs["sorted_ep"], bufs["unsorted"]),
          "the sorted and unsorted dispatches build the same buffer")
    print(f"dispatch A/B deepseek-v3 T={t} k={m.top_k} E={m.num_experts} capacity={cap} "
          f"d={cfg.d_model} bf16: sorted_ep_ms={times['sorted_ep']} "
          f"unsorted_ms={times['unsorted']} (events around Python calls; the same "
          f"buffer) [{card}]")
    del tokens, router, gates, eidx, bufs
    torch.cuda.empty_cache()
    return out


def moe_oracle(p, cfg, x):
    """An MoE layer computed independently of the port's dispatch, expert
    and combine code: for each expert a float32 loop over the first
    ``capacity`` tokens, in token order, that chose it (routing from the
    port's float32 ``_route``, the same product), the expert's SwiGLU in
    float32 on float32 copies of its weights, gates applied, summed per
    token with ``index_add_``; the shared expert added in float32.
    x: (T, d); returns (T, d) float32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.transformer import moe

    m = cfg.moe
    t = x.shape[0]
    gates, eidx = moe._route(x, p.router, m)
    cap = moe._capacity(t, m, m.num_experts)
    xf = x.float()
    out = torch.zeros(t, x.shape[1], device=x.device)
    kept = 0
    for e in range(m.num_experts):
        tok, slot = (eidx == e).nonzero(as_tuple=True)  # token order
        tok, slot = tok[:cap], slot[:cap]
        kept += tok.numel()
        xe = xf[tok]
        h = F.silu(xe @ p.w_gate[e].float()) * (xe @ p.w_up[e].float())
        out.index_add_(0, tok, (h @ p.w_down[e].float()) * gates[tok, slot, None])
    if m.num_shared_experts:
        h = F.silu(xf @ p.w_gate_shared.float()) * (xf @ p.w_up_shared.float())
        out += h @ p.w_down_shared.float()
    return out, kept, cap


def check_moe_layers(params, cfg, tokens) -> None:
    """Each MoE layer of ``params`` against ``moe_oracle`` on the input
    it gets in a forward of ``tokens`` (the trunk run layer by layer)."""
    import torch

    from repro_torch.models.common import activation_fn, rms_norm
    from repro_torch.models.transformer import model, moe

    act = activation_fn(cfg.activation)
    with torch.inference_mode():
        x = model.embed_lookup(params, cfg, model.as_tokens(params, tokens))
        b, s = tokens.shape
        positions = model._positions(b, s, x.device)
        for group, i, layer in params.layers():
            if layer.moe is None:
                x = model._layer_fwd(layer, cfg, x, positions)
                continue
            h = x + model._attn(layer.attn, cfg, rms_norm(x, layer.ln1), positions)
            hn = rms_norm(h, layer.ln2)
            got = moe.moe_ffn(layer.moe, cfg, hn, act)
            want, kept, cap = moe_oracle(layer.moe, cfg, hn.reshape(b * s, -1))
            rows_within(f"{cfg.name} {group} layer {i} MoE (T={b * s}, capacity {cap}, "
                       f"{b * s * cfg.moe.top_k - kept} copies dropped) against the "
                       f"float32 oracle", got.reshape(b * s, -1), want, MOE_TOL)
            x = h + got
            del want


@contextlib.contextmanager
def recorded_routes():
    """Record each call of the MoE router (``moe._route``): the chosen
    experts (T, k) and the gap between the k-th and (k+1)-th probability
    of each token."""
    import torch

    from repro_torch.models.transformer import moe

    calls = []
    route = moe._route

    def record(tokens, router, m):
        gates, eidx = route(tokens, router, m)
        probs = torch.softmax(tokens.float() @ router, dim=-1)
        top = probs.topk(m.top_k + 1, dim=-1).values
        calls.append((eidx.sort(-1).values, top[:, -2] - top[:, -1]))
        return gates, eidx

    moe._route = record
    try:
        yield calls
    finally:
        moe._route = route


def moe_consistency(params, cfg, tokens) -> float:
    """Phase 16's prefill against decode (B = 1): ``forward``'s logits and
    the decode loop's at every position, each MoE layer's routing recorded
    in both. bf16 activations differ between the two paths by a rounding,
    so a token whose k-th and (k+1)-th router probabilities nearly tie can
    take another expert in one of them (a routing flip): such tokens are
    counted, each must have had a gap below 1e-2 at its first flip, and
    the margin rule holds at every other position. Returns the largest
    |logit difference| over the positions without a flip."""
    import torch

    from repro_torch.models.transformer import forward, init_kv_cache, serve_step

    b, s = tokens.shape
    n_moe = cfg.num_moe_layers()
    with torch.inference_mode():
        with recorded_routes() as fwd_routes:
            full = forward(params, cfg, tokens)[0]
        tok = torch.from_numpy(np.ascontiguousarray(tokens)).to(full.device)
        cache = init_kv_cache(cfg, b, s, device=full.device)
        dec = torch.empty_like(full)
        with recorded_routes() as dec_routes:
            for i in range(s):
                logits, cache = serve_step(params, cfg, cache, tok[:, i:i + 1], i)
                dec[i] = logits[0, 0]
        del cache
    flipped = torch.zeros(s, dtype=torch.bool, device=full.device)
    gaps = []
    for layer in range(n_moe):
        fwd_e, fwd_gap = fwd_routes[layer]
        dec_e = torch.cat([dec_routes[i * n_moe + layer][0] for i in range(s)])
        dec_gap = torch.cat([dec_routes[i * n_moe + layer][1] for i in range(s)])
        flip = (fwd_e != dec_e).any(-1)
        # A token's first flip is a near-tie; past it the token's hidden
        # state differs, and its later layers may route apart freely.
        gaps += torch.minimum(fwd_gap, dec_gap)[flip & ~flipped].tolist()
        flipped |= flip
    keep = ~flipped
    diff = (full - dec).abs()
    max_diff = float(diff[keep].max())
    print(f"prefill vs decode {cfg.name} B={b} S={s}, every position: routing flips at "
          f"{int(flipped.sum())} positions {flipped.nonzero().flatten().tolist()} with router "
          f"gaps at the first flip {[round(g, 6) for g in gaps]}; elsewhere max_abs_diff={max_diff} "
          f"mean_abs_diff={float(diff[keep].mean())}; at the flips max_abs_diff="
          f"{float(diff[flipped].max()) if flipped.any() else 0.0}")
    check(all(g < 1e-2 for g in gaps), f"{cfg.name}: every routing flip is a near-tie")
    margin_agreement(dec[keep], full[keep], f"prefill vs decode {cfg.name}, positions "
                     f"without a routing flip")
    return max_diff


def moe_prompts(cfg):
    """``MOE_SERVE_REQUESTS`` prompts of 16-128 tokens from ``lm_batch``."""
    from repro_torch.data.lm import lm_batch

    lengths = np.random.default_rng(0).integers(16, 129, MOE_SERVE_REQUESTS)
    toks = lm_batch(MOE_SERVE_REQUESTS, 128, cfg.vocab_size, seed=1)["tokens"]
    return [toks[i, :n].tolist() for i, n in enumerate(lengths)]


def moe_cell(dev, name: str, layers: int, prefill_s: int, serve_len: int, card: str) -> dict:
    """One model of phase 16 at its published width, ``layers`` deep:
    init, each MoE layer against the oracle, the prefill (launches counted
    from 0, timed, peak memory, idle share), the MTP head where the model
    has one, prefill against decode on a prefix with no token dropped,
    and ``ServeEngine`` on ``lm_batch`` prompts. Returns the report."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.lm import lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import forward, hidden_states, init_params
    from repro_torch.models.transformer.model import _mtp_logits

    full = get_arch(name).config
    cfg = dataclasses.replace(full, num_layers=layers)
    cut = (f"{name} at full width, {cfg.num_dense_layers_effective()} dense + "
           f"{cfg.num_moe_layers()} MoE of {full.num_dense_layers_effective()} + "
           f"{full.num_moe_layers()} layers" + (", the MTP layer" if cfg.mtp_depth else ""))
    t0 = time.perf_counter()
    params = init_params(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model {cut}: params={n_params} dtype={cfg.dtype} "
          f"init_s={time.perf_counter() - t0} memory_gb={torch.cuda.memory_allocated() / 1e9}")
    tokens = lm_batch(1, prefill_s, cfg.vocab_size, seed=0)["tokens"]
    check_moe_layers(params, cfg, tokens)
    rep = {"label": cut}
    with torch.inference_mode():
        forward(params, cfg, tokens)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        logits, first = wall_s(lambda: forward(params, cfg, tokens))
        counts = dict(launch_counts)
        rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(counts["flash_attention"] == layers,
              f"{name}: flash_attention launched {counts['flash_attention']} times in a "
              f"forward of {layers} layers")
        check(counts["segment_sum"] == cfg.num_moe_layers(),
              f"{name}: segment_sum launched {counts['segment_sum']} times in a forward "
              f"of {cfg.num_moe_layers()} MoE layers (the combine)")
        check(tuple(logits.shape) == (1, prefill_s, cfg.vocab_size)
              and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
              f"{name}: finite float32 logits (1, S, V)")
        del logits
        secs = [first] + [wall_s(lambda: forward(params, cfg, tokens))[1]
                          for _ in range(E2E_SAMPLES - 1)]
        _, busy, events, ranked, idle = device_share(lambda: forward(params, cfg, tokens),
                                                     top=8)
        rep.update(counts=counts, prefill_s=median(secs), idle=idle,
                   tps=prefill_s / median(secs))
        print(f"prefill {cut} B=1 S={prefill_s}: wall_ms={rep['prefill_s'] * 1e3} "
              f"samples_ms={[x * 1e3 for x in secs]} tokens_per_s={rep['tps']} "
              f"launches={counts} peak_memory_gb={rep['peak_gb']} device_busy_ms={busy} "
              f"device_events={events} device_idle_share={idle} [{card}]")
        for kernel, ms in ranked:
            print(f"prefill {name} device time by kernel: {ms:.3f} ms {kernel[:110]}")
        if cfg.mtp_depth:
            hidden = hidden_states(params, cfg, tokens)
            reset_launch_counts()
            mtp, mtp_s = wall_s(lambda: _mtp_logits(params, cfg, hidden, tokens))
            rep["mtp_launches"] = launch_counts["flash_attention"]
            check(rep["mtp_launches"] == 1 and tuple(mtp.shape) == (1, prefill_s, cfg.vocab_size)
                  and bool(torch.isfinite(mtp).all()),
                  f"{name}: the MTP head's finite logits, one flash_attention launch")
            rep["mtp_s"] = mtp_s
            print(f"mtp {cut} S={prefill_s}: wall_ms={mtp_s * 1e3} "
                  f"flash_attention launches={rep['mtp_launches']} "
                  f"logit_std={float(mtp.std())} [{card}]")
            del hidden, mtp
    # Prefill against decode with every token kept: a capacity of every
    # token (capacity_factor max(8, E / k)) in both the prefill and each
    # step, so only routing flips (near-ties) tell the two apart.
    m = cfg.moe
    keep_all = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=max(8.0, m.num_experts / m.top_k)))
    rep["consistency"] = moe_consistency(params, keep_all, tokens[:, :MOE_CONSISTENCY_S])
    rep["serving"] = phase_serving(params, cfg, MOE_SERVE_SLOTS, serve_len,
                                   MOE_SERVE_REQUESTS, True, label=cut,
                                   prompts=moe_prompts(cfg), rescore=False)
    del params
    torch.cuda.empty_cache()
    return rep


def phase_moe(dev, card: str) -> dict:
    """Phase 16: the kernels' times at the new shapes, then mixtral-8x7b
    and deepseek-v3 in turn (each freed before the next). Returns the
    cells, the kernel times and the phase's seconds."""
    t_phase = time.perf_counter()
    times = moe_kernel_times(dev, card)
    cells = {name: moe_cell(dev, name, layers, s, serve_len, card)
             for name, layers, s, serve_len in MOE_CELLS}
    secs = time.perf_counter() - t_phase
    print(f"phase 16 moe, mla and mtp: s={secs}")
    return {"cells": cells, "times": times, "secs": secs}


# ---------------------------------------------------------------------------
# Phase 17: single-device training
# ---------------------------------------------------------------------------

ATTN_BWD_SHAPE = (1, 32, 8, 4096, 128)  # qwen3-4b's training shape: B, Hq, Hkv, S, D
ATTN_BWD_TOL = {"bfloat16": 3e-2, "float32": 2e-3}
ATTN_BWD_CASES = (  # (label, B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, dtype)
    ("qwen3-4b training shape", 1, 32, 8, 4096, 4096, 128, 128, True, None, "bfloat16"),
    ("mixtral window=4096 S=8192", 1, 4, 1, 8192, 8192, 128, 128, True, 4096, "bfloat16"),
    ("short window=100 S=1000", 1, 32, 8, 1000, 1000, 128, 128, True, 100, "bfloat16"),
    ("MLA (192, 128) S=1024", 1, 8, 8, 1024, 1024, 192, 128, True, None, "bfloat16"),
    ("GQA S=300", 2, 4, 2, 300, 300, 64, 64, True, None, "float32"),
    ("non-causal ragged S=777", 1, 4, 4, 777, 777, 96, 96, False, None, "bfloat16"),
    ("Sq=129 Sk=1000 causal", 1, 8, 2, 129, 1000, 128, 128, True, None, "bfloat16"),
) + tuple(
    (f"head_dim={d} S=1000", 1, 8, 2, 1000, 1000, d, d, True, None, "bfloat16")
    for d in (16, 32)
) + tuple(
    (f"rows without a live key Sq=300 Sk=100 window=64", 1, 4, 2, 300, 100, 64, 64,
     True, 64, dt) for dt in ("bfloat16", "float32")
) + tuple(
    (f"head_dim={d} S=130", 2, 4, 2, 130, 130, d, d, True, None, dt)
    for d in (16, 32, 64, 96, 128, 256) for dt in ("bfloat16", "float32")
)


def attention_bwd_bound_ms(b, hq, hkv, sq, sk, d, dv, causal, window, itemsize):
    """``(bound_ms, flops, bytes)`` of attention's backward: the larger of
    its five products over the live pairs (S = Q K^T and dK = dS^T Q,
    dQ = dS K over ``d``; dP = dO V^T and dV = P^T dO over ``dv``) at the
    bf16 tensor-core peak, and its bytes (q, k, v, out, dout read once;
    dq, dk, dv written once) at the HBM rate."""
    flops = 2 * (3 * d + 2 * dv) * b * hq * live_pairs(sq, sk, causal, window)
    nbytes = itemsize * (b * hq * sq * (2 * d + 2 * dv) + 2 * b * hkv * sk * (d + dv))
    return (max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
            flops, nbytes)


def grad_within(name: str, got, want, dtype_name: str) -> float:
    """One gradient of the kernel against the plain version. float32:
    ``|got - want| <= tol * rms(want) + tol * |want|`` everywhere. bf16:
    ``||got - want|| <= tol * ||want||`` in norm, with the elementwise
    worst (in units of ``rms(want) + |want|``) printed beside it, since a
    few elements of a bf16 gradient that sum thousands of rounded
    products can differ by more. Returns max |got - want|."""
    import torch

    tol = ATTN_BWD_TOL[dtype_name]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: finite gradient")
    diff = (g - w).abs()
    rms = float(w.square().mean().sqrt())
    norm_err = float(diff.norm() / max(float(w.norm()), 1e-30))
    worst = float((diff / (rms + w.abs()).clamp_min(1e-30)).max())
    over = int((diff > tol * rms + tol * w.abs()).sum())
    err = float(diff.max())
    print(f"flash_attention.bwd {name}: max_abs_err={err} norm_err={norm_err} "
          f"elementwise_worst={worst} over_elementwise_tol={over} tol={tol}")
    if dtype_name == "float32":
        check(over == 0, f"{name}: within rtol {tol}, atol {tol} * rms of the plain VJP")
    else:
        check(norm_err <= tol, f"{name}: within {tol} in norm of the plain VJP")
    return err


def lse_within(name: str, got, want, dtype_name: str) -> float:
    """The forward's log-sum-exp against ``attention_lse_ref``'s: +inf on
    the same rows (those with no live key), elsewhere within
    ``ATTN_LSE_TOL``. Returns the worst absolute error on finite rows."""
    import torch

    dead = torch.isinf(want)
    check(bool(torch.equal(torch.isinf(got), dead)) and bool((got[dead] > 0).all()),
          f"{name}: lse is +inf exactly on the rows with no live key")
    err = float((got[~dead] - want[~dead]).abs().max()) if bool((~dead).any()) else 0.0
    print(f"flash_attention lse {name}: max_abs_err={err} rows_without_live_key="
          f"{int(dead.sum())} tol={ATTN_LSE_TOL[dtype_name]}")
    check(err <= ATTN_LSE_TOL[dtype_name], f"{name}: lse within {ATTN_LSE_TOL[dtype_name]}")
    return err


def phase_attention_bwd(dev) -> float:
    """Phase 17 (a): at each of ``ATTN_BWD_CASES`` the forward's log-sum-exp
    against ``attention_lse_ref`` and the backward kernel, on the design
    ``bwd_design`` names, against ``attention_vjp_ref``; at the training
    shape also two calls bit-equal and the autograd Function's gradients
    equal to the direct call's. Returns the largest max_abs_err of the
    gradients by design."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import (
        bwd_design,
        flash_attention_bwd,
        flash_attention_lse,
    )
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref, attention_vjp_ref

    gen = torch.Generator(dev).manual_seed(17)
    errs, lse_errs, designs = {}, [], set()
    for label, b, hq, hkv, sq, sk, d, dv, causal, window, dt in ATTN_BWD_CASES:
        dtype = getattr(torch, dt)
        q, k, v, dout = (torch.randn(b, h, s, w, device=dev, generator=gen).to(dtype)
                         for h, s, w in ((hq, sq, d), (hkv, sk, d), (hkv, sk, dv),
                                         (hq, sq, dv)))
        design = bwd_design(dtype, d, dv)
        designs.add(design)
        name = (f"{label} B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} D={d} Dv={dv} "
                f"causal={causal} window={window} {dt} [{design}]")
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window, impl="cuda")
        lse_errs.append(lse_within(name, lse, attention_lse_ref(
            q, k, causal=causal, window=window), dt))
        got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
        torch.cuda.synchronize()
        want = attention_vjp_ref(q, k, v, dout, causal=causal, window=window)
        for grad_name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[design] = max(errs.get(design, 0.0),
                               grad_within(f"{name} {grad_name}", g, w, dt))
        if label.startswith("qwen3-4b"):
            again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  "the backward kernel: two calls give the same bits")
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = launch_counts["flash_attention.bwd"]
            o = flash_attention(*leaves, causal=causal, window=window, impl="cuda")
            o.backward(dout)
            check(launch_counts["flash_attention.bwd"] == before + 1
                  and all(torch.equal(x.grad, y) for x, y in zip(leaves, got)),
                  "the autograd Function's gradients are the direct call's, one launch")
            print("flash_attention.bwd: two calls bit-equal; the autograd Function "
                  "gives the direct call's bits")
            del again, leaves, o
        del q, k, v, dout, out, lse, got, want
    check(designs == {"wgmma", "wmma"}, f"phase 17 (a) holds both designs: {designs}")
    print(f"flash_attention.bwd: {len(ATTN_BWD_CASES)} cases on the designs {sorted(designs)}; "
          f"worst lse error {max(lse_errs)}, worst gradient error by design {errs}")
    torch.cuda.empty_cache()
    return errs


def sdpa_backward_ms(q, k, v, dout) -> tuple:
    """``(ms, backend)``: the backward of one causal SDPA call at these
    inputs (the yardstick; the port never calls it), with PyTorch's own
    choice of backend where Dv = D, else the first of flash, cuDNN and
    efficient whose forward and backward take the shapes; ``(None, why)``
    where none does."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    gqa = q.shape[1] != k.shape[1]
    if q.shape[-1] == v.shape[-1]:
        choices = [None]
    else:
        choices = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                   SDPBackend.EFFICIENT_ATTENTION]
    for backend in choices:
        ctx = contextlib.nullcontext() if backend is None else sdpa_kernel([backend])
        try:
            with ctx:
                o = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=gqa)
                torch.autograd.grad(o, leaves, dout, retain_graph=True)
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True),
                             iters=10, warmup=2)
            return ms, "default" if backend is None else backend.name
        except RuntimeError as err:
            print(f"sdpa backward {backend.name} refuses (D, Dv) = ({q.shape[-1]}, "
                  f"{v.shape[-1]}): {str(err).splitlines()[0][:160]}")
    return None, "no backend takes the shapes"


def backward_passes(call) -> tuple:
    """``(pass 1 ms, pass 2 ms)`` of one backward call, by their device
    time in a profile."""
    _, _, _, ranked, _ = device_share(call, top=50)
    times = [sum(ms for name, ms in ranked if tag in name)
             for tag in ("attn_bwd_dq_", "attn_bwd_dkdv_")]
    check(all(ms > 0 for ms in times), f"both passes in the profile: {ranked}")
    return tuple(times)


def attention_bwd_times(dev, card: str, shape=ATTN_BWD_SHAPE, dv=None) -> tuple:
    """Phase 17 (a)'s times at ``shape`` (B, Hq, Hkv, S, D; causal; Dv =
    ``dv`` or D): the backward kernel (and each of its passes), its plain
    version, the SDPA backward that takes the shape (the yardstick; the
    port never calls it) and the FLOP bound. Returns ``(ms, plain_ms,
    library_ms, bound_ms)``."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import (
        bwd_design,
        flash_attention_bwd,
        flash_attention_lse,
    )
    from repro_torch.kernels.flash_attention.ref import attention_vjp_ref

    b, hq, hkv, s, d = shape
    dv = d if dv is None else dv
    gen = torch.Generator(dev).manual_seed(18)
    q, k, v, dout = (torch.randn(b, h, s, w, device=dev, generator=gen).to(torch.bfloat16)
                     for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv)))
    out, lse = flash_attention_lse(q, k, v, impl="cuda")
    bound_ms, flops, nbytes = attention_bwd_bound_ms(b, hq, hkv, s, s, d, dv, True, None, 2)
    call = lambda: flash_attention_bwd(q, k, v, out, dout, lse)  # noqa: E731
    ms = cuda_ms(call, iters=10, warmup=2)
    pass1, pass2 = backward_passes(call)
    plain_ms = cuda_ms(lambda: attention_vjp_ref(q, k, v, dout), iters=3, warmup=1)
    lib_ms, backend = sdpa_backward_ms(q, k, v, dout)
    fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, impl="cuda"), iters=10, warmup=2)
    print(f"time flash_attention.bwd [{bwd_design(q.dtype, d, dv)}] B={b} Hq={hq} Hkv={hkv} "
          f"S={s} D={d} Dv={dv} bf16 causal: ms={ms} pass1_dq_ms={pass1} "
          f"pass2_dkdv_ms={pass2} plain_ms={plain_ms} library_ms(sdpa backward, "
          f"{backend})={lib_ms} bound_ms={bound_ms} flops={flops} bytes={nbytes} "
          f"share_of_bound={bound_ms / ms} tflops={flops / ms / 1e9} "
          f"seven_product_bound_ms={bound_ms * (4 * d + 3 * dv) / (3 * d + 2 * dv)} "
          f"forward_kernel_ms={fwd_ms} [{card}]")
    del q, k, v, dout, out, lse
    torch.cuda.empty_cache()
    return ms, plain_ms, lib_ms, bound_ms


TRAIN_LM_LAYERS = 36  # qwen3-4b's depth: all of it
TRAIN_LM_S = 4096
TRAIN_LM_STEPS = 6  # cut from 8 to fit phase 19 in the 1,200 s budget
TRAIN_LM_LR = 1e-3
TRAIN_CUT_LAYERS = 2  # the cut on which the two routes' gradients are held
TRAIN_GRAD_TOL = 3e-2  # bf16 gradients of the two routes, per leaf in norm
TRAIN_MICRO_TOL = 1e-3  # the 2-microbatch step against the mean of its halves
# Phase 17 (e): deepseek-v3 at full width cut to its 3 dense layers and
# the MTP layer, one loss-and-gradients step at B=1: its MLA attention,
# (D, Dv) = (192, 128), is the backward's wmma design on the main path. S
# is cut to 2048 so that the plain route's (1, 128, S, S) float32 scores
# and their autograd (~2.1 GB each) fit beside the model.
TRAIN_MLA_ARCH = "deepseek-v3-671b"
TRAIN_MLA_S = 2048
TRAIN_MLA_ATTN = (1, 128, 128, TRAIN_MLA_S, 192)  # its attention: B, Hq, Hkv, S, D (Dv 128)
TRAIN_GNN_STEPS = 3
SHARDED_S = 2048
SHARDED_MIXTRAL_S = 4096
SHARDED_DECODE_STEPS = 4
TRAIN_GNN_LR = 1e-3
TRAIN_GNN_TOL = 2e-3  # float32 gradients against the index_add_ forward's


def leaf_norm_errs(got, want) -> list:
    """``||g - w|| / ||w||`` of each pair of gradients (float32)."""
    return [float((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30))
            for g, w in zip(got, want)]


@contextlib.contextmanager
def attention_on_plain_route():
    """The LM's attention through ``flash_attention(..., impl="torch")``
    (``attention_ref``, autograd included) for the duration."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import attention

    attention.flash_attention = functools.partial(flash_attention, impl="torch")
    try:
        yield
    finally:
        attention.flash_attention = flash_attention


def lm_train_batch(dev, b: int, seed: int, vocab: int, s: int = TRAIN_LM_S) -> dict:
    import torch

    from repro_torch.data.lm import lm_batch

    batch = lm_batch(b, s, vocab, seed=seed)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def phase_train_lm(dev, card: str) -> dict:
    """Phase 17 (b): qwen3-4b training at full width. On a 2-layer cut,
    every gradient on the kernel route against the ``impl="torch"`` route
    and a 2-microbatch step at B=2 against the mean of its halves; then
    ``train()`` at ``TRAIN_LM_LAYERS`` layers on one repeated batch, its
    launches counted from 0, and one profiled step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.loop import LoopConfig, make_train_step, train, value_and_grads
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.tree import leaf_name, named_leaves, trainable

    t_phase = time.perf_counter()
    full = dataclasses.replace(get_arch(LM_ARCH).config, remat=True)
    cut = dataclasses.replace(full, num_layers=TRAIN_CUT_LAYERS)
    params = trainable(init_params(cut, device=dev,
                                   generator=torch.Generator(dev).manual_seed(0)))
    lm_loss = lambda p, b: loss_fn(p, cut, b)  # noqa: E731
    batch = lm_train_batch(dev, 1, 0, full.vocab_size)
    reset_launch_counts()
    loss_k, grads_k = value_and_grads(lm_loss, params, batch)
    counts = dict(launch_counts)
    check(counts["flash_attention"] == 2 * TRAIN_CUT_LAYERS
          and counts["flash_attention.bwd"] == TRAIN_CUT_LAYERS,
          f"the cut's step: a forward launch a layer and one more in its "
          f"recompute, a backward launch a layer: {counts}")
    with attention_on_plain_route():
        loss_t, grads_t = value_and_grads(lm_loss, params, batch)
    check(launch_counts["flash_attention.bwd"] == TRAIN_CUT_LAYERS,
          "the plain route launches no kernel")
    errs = leaf_norm_errs(grads_k, grads_t)
    names = [leaf_name(p) for p, _ in named_leaves(params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    print(f"train {LM_ARCH} {TRAIN_CUT_LAYERS}-layer cut B=1 S={TRAIN_LM_S}: "
          f"loss kernel={float(loss_k)} plain={float(loss_t)}; gradients of "
          f"{len(errs)} leaves, kernel route vs impl=\"torch\" in norm: worst "
          f"{errs[worst]} ({names[worst]}), median {median(errs)}")
    check(abs(float(loss_k) - float(loss_t)) <= 1e-2 * abs(float(loss_t)),
          "the two routes' losses agree")
    check(max(errs) <= TRAIN_GRAD_TOL,
          f"every gradient within {TRAIN_GRAD_TOL} in norm of the plain route's")
    del grads_k, grads_t
    batch2 = lm_train_batch(dev, 2, 1, full.vocab_size)
    loss_m, grads_m = value_and_grads(lm_loss, params, batch2, num_microbatches=2)
    halves = [value_and_grads(lm_loss, params, {k: v[i:i + 1] for k, v in batch2.items()})
              for i in range(2)]
    mean = [(a.float() + b.float()) * 0.5 for a, b in zip(halves[0][1], halves[1][1])]
    micro_errs = leaf_norm_errs(grads_m, mean)
    max_diff = max(float((g - w).abs().max()) for g, w in zip(grads_m, mean))
    print(f"train {LM_ARCH} cut: num_microbatches=2 at B=2: loss={float(loss_m)} "
          f"mean of halves={(float(halves[0][0]) + float(halves[1][0])) / 2} "
          f"grads float32={all(g.dtype == torch.float32 for g in grads_m)} "
          f"worst norm err vs the mean of the halves' grads={max(micro_errs)} "
          f"max_abs_diff={max_diff}")
    check(all(g.dtype == torch.float32 for g in grads_m),
          "microbatch gradients accumulate in float32")
    check(max(micro_errs) <= TRAIN_MICRO_TOL,
          "the 2-microbatch step's gradients are the mean of its halves'")
    del params, grads_m, halves, mean, batch2
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, num_layers=TRAIN_LM_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"train {LM_ARCH} {TRAIN_LM_LAYERS} layers: init_s={time.perf_counter() - t0} "
          f"weights_gb={sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9}")
    opt_cfg = AdamWConfig(lr=TRAIN_LM_LR, warmup_steps=2, total_steps=TRAIN_LM_STEPS)
    lm_loss = lambda p, b: loss_fn(p, cfg, b)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    params, out = train(params, lm_loss, iter(lambda: batch, None), opt_cfg,
                        LoopConfig(total_steps=TRAIN_LM_STEPS, log_every=TRAIN_LM_STEPS))
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in out["history"]]
    step_s = [h["dt"] for h in out["history"]]
    steady = median(step_s[1:])
    want = {"flash_attention": 2 * TRAIN_LM_LAYERS * TRAIN_LM_STEPS,
            "flash_attention.bwd": TRAIN_LM_LAYERS * TRAIN_LM_STEPS}
    print(f"train {LM_ARCH} {TRAIN_LM_LAYERS} layers B=1 S={TRAIN_LM_S} bf16, float32 "
          f"moments, remat: losses={losses} step_ms={[x * 1e3 for x in step_s]} "
          f"launches={counts} peak_memory_gb={peak_gb} [{card}]")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] - 0.5,
          f"the loss falls on a repeated batch: {losses}")
    check(all(counts[k] == v for k, v in want.items()),
          f"train() went through both attention kernels: {counts}, want {want}")
    # One profiled step, on a fresh optimizer state (train() dropped its own).
    opt_state = init_opt_state(params, opt_cfg)
    step = make_train_step(lm_loss, opt_cfg)
    wall_ms, busy_ms, events, ranked, idle = device_share(
        lambda: step(params, opt_state, None, batch), top=10_000)
    bwd_ms = sum(ms for name, ms in ranked if "attn_bwd" in name)
    fwd_ms = sum(ms for name, ms in ranked if "attn_tc_kernel" in name)
    print(f"train {LM_ARCH} profiled step: wall_ms={wall_ms} device_busy_ms={busy_ms} "
          f"device_events={events} device_idle_share={idle} attention_bwd_ms={bwd_ms} "
          f"attention_bwd_share_of_busy={bwd_ms / busy_ms} attention_fwd_ms={fwd_ms}")
    for name, ms in ranked[:8]:
        print(f"train {LM_ARCH} device time by kernel: {ms:.3f} ms {name[:110]}")
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return {"step_s": steady, "tps": TRAIN_LM_S / steady, "peak_gb": peak_gb,
            "idle": idle, "bwd_share": bwd_ms / busy_ms, "losses": losses,
            "counts": counts, "secs": time.perf_counter() - t_phase}


def phase_train_mla(dev, card: str) -> dict:
    """Phase 17 (e): ``TRAIN_MLA_ARCH`` at full width, its dense layers and
    the MTP layer, B=1, S=``TRAIN_MLA_S``: one ``value_and_grads`` on the
    kernel route, its launches counted from 0 (MLA's attention: a forward
    launch a layer, one more in each remat recompute, and a backward
    launch a layer on its wmma design), its gradients against the
    ``impl="torch"`` route's, and its wall time."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.train.loop import value_and_grads
    from repro_torch.train.tree import leaf_name, named_leaves, trainable

    t_phase = time.perf_counter()
    full = get_arch(TRAIN_MLA_ARCH).config
    cfg = dataclasses.replace(full, num_layers=full.num_dense_layers)
    params = trainable(init_params(cfg, device=dev,
                                   generator=torch.Generator(dev).manual_seed(0)))
    mla_loss = lambda p, b: loss_fn(p, cfg, b)  # noqa: E731
    batch = lm_train_batch(dev, 1, 2, cfg.vocab_size, TRAIN_MLA_S)
    value_and_grads(mla_loss, params, batch)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss_k, grads_k = value_and_grads(mla_loss, params, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(launch_counts)
    dense, mtp = cfg.num_dense_layers_effective(), cfg.mtp_depth
    want = {"flash_attention": dense * (2 if cfg.remat else 1) + mtp,
            "flash_attention.bwd.wmma": dense + mtp, "flash_attention.bwd": 0}
    check(all(counts[k] == v for k, v in want.items()),
          f"the MLA step went through the forward and the wmma backward: {counts}, "
          f"want {want}")
    with attention_on_plain_route():
        loss_t, grads_t = value_and_grads(mla_loss, params, batch)
    errs = leaf_norm_errs(grads_k, grads_t)
    names = [leaf_name(p) for p, _ in named_leaves(params)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    print(f"train {TRAIN_MLA_ARCH} {dense} dense layers + MTP at full width B=1 "
          f"S={TRAIN_MLA_S}: "
          f"loss kernel={float(loss_k)} plain={float(loss_t)} wall_ms={secs * 1e3} "
          f"launches={counts}; gradients of {len(errs)} leaves, kernel route vs "
          f"impl=\"torch\" in norm: worst {errs[worst]} ({names[worst]}), median "
          f"{median(errs)} [{card}]")
    check(abs(float(loss_k) - float(loss_t)) <= 1e-2 * abs(float(loss_t)),
          "the two routes' MLA losses agree")
    check(max(errs) <= TRAIN_GRAD_TOL,
          f"every MLA gradient within {TRAIN_GRAD_TOL} in norm of the plain route's")
    del params, grads_k, grads_t, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "secs": time.perf_counter() - t_phase, "step_s": secs}


def phase_train_gnn(dev, ogb: dict, card: str) -> dict:
    """Phase 17 (c) and (d): gin-tu training on the ogb_products graph.
    The first step's gradients against the autograd of the independent
    ``index_add_`` forward; ``train()`` for ``TRAIN_GNN_STEPS`` steps with
    a checkpoint at the end; the checkpoint restored, saved again and
    restored, bit-equal."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.common import node_nll
    from repro_torch.models.gnn import gin
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import LoopConfig, train, value_and_grads
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.tree import copy_into, leaves, named_leaves, trainable

    t_phase = time.perf_counter()
    graph = gnn_on_card(ogb, dev)
    graph["labels"] = torch.from_numpy(ogb["labels"]).to(dev)
    cfg = get_arch("gin-tu").config_for(GNN_SHAPE)
    params = trainable(gin.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                       device=dev))
    gnn_loss = lambda p, b: gin.loss_fn(p, cfg, b)  # noqa: E731
    reset_launch_counts()
    loss_k, grads_k = value_and_grads(gnn_loss, params, graph)
    check(launch_counts["segment_sum"] == cfg.num_layers,
          f"gin's step: one segment_sum launch a layer, got {launch_counts['segment_sum']}")
    torch.cuda.empty_cache()
    index_loss = lambda p, b: node_nll(  # noqa: E731
        gnn_by_index_add("gin-tu", p, cfg, b), b["labels"])
    loss_i, grads_i = value_and_grads(index_loss, params, graph)
    errs = leaf_norm_errs(grads_k, grads_i)
    print(f"train gin-tu {GNN_SHAPE}: first step loss={float(loss_k)} index_add "
          f"forward's={float(loss_i)}; gradients of {len(errs)} leaves in norm: worst "
          f"{max(errs)} median {median(errs)}")
    check(max(errs) <= TRAIN_GNN_TOL,
          f"gin's gradients within {TRAIN_GNN_TOL} in norm of the index_add_ forward's")
    del grads_k, grads_i
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        opt_cfg = AdamWConfig(lr=TRAIN_GNN_LR, warmup_steps=1, total_steps=TRAIN_GNN_STEPS)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        params, out = train(params, gnn_loss, iter(lambda: graph, None), opt_cfg,
                            LoopConfig(total_steps=TRAIN_GNN_STEPS,
                                       checkpoint_every=TRAIN_GNN_STEPS,
                                       checkpoint_dir=f"{tmp}/a", log_every=100))
        counts = dict(launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [h["loss"] for h in out["history"]]
        step_s = [h["dt"] for h in out["history"]]
        m = graph["src"].shape[0]
        steady = median(step_s[1:])
        print(f"train gin-tu {GNN_SHAPE} n={graph['node_feats'].shape[0]} m={m}: "
              f"losses={losses} step_ms={[x * 1e3 for x in step_s]} "
              f"edges_per_s={cfg.num_layers * m / steady} launches={counts} "
              f"peak_memory_gb={peak_gb} [{card}]")
        check(counts["segment_sum"] == cfg.num_layers * TRAIN_GNN_STEPS,
              f"train() went through segment_sum once a layer a step: {counts}")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"gin's loss falls: {losses}")
        # (d): the checkpoint of train()'s last step, restored; saved again
        # from the card and restored; bit-equal throughout.
        like = {"params": params, "opt_state": init_opt_state(params, opt_cfg)}
        first = CheckpointManager(f"{tmp}/a").restore(TRAIN_GNN_STEPS, like)
        check(int(first["opt_state"]["step"]) == TRAIN_GNN_STEPS
              and all(torch.equal(a.cpu(), b) for a, b in
                      zip(leaves(params), leaves(first["params"]))),
              "the checkpoint holds train()'s last parameters and step")
        copy_into(like, first)
        second_mgr = CheckpointManager(f"{tmp}/b")
        second_mgr.save(TRAIN_GNN_STEPS, like)
        second_mgr.wait()
        second = second_mgr.restore(TRAIN_GNN_STEPS, like)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b) in
                   zip(named_leaves(first), named_leaves(second)))
        nbytes = sum(x.numel() * x.element_size() for x in leaves(second))
        print(f"checkpoint gin-tu state: {len(leaves(second))} leaves, {nbytes} bytes, "
              f"save -> restore -> save from the card -> restore bit-equal={same}")
        check(same, "the checkpoint round trip is bit-equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params, graph, like
    torch.cuda.empty_cache()
    return {"step_s": steady, "eps": cfg.num_layers * m / steady, "peak_gb": peak_gb,
            "counts": counts, "losses": losses, "secs": time.perf_counter() - t_phase}


def sharded_lm_cfg():
    """deepseek-v3 at full width: its dense layers, one MoE layer (all 256
    experts), and the MTP layer."""
    from repro_torch.configs import get_arch

    full = get_arch(TRAIN_MLA_ARCH).config
    return dataclasses.replace(full, num_layers=full.num_dense_layers + 1)


def lm_grads(params, cfg, batch, mesh=None, specs=None):
    """``(loss, {name: gradient})`` of ``loss_fn`` (``.backward()``); on a
    mesh each rank's gradients summed over the batch axes."""
    import torch

    from repro_torch.distributed.sharding import reduce_gradients
    from repro_torch.models.transformer import loss_fn
    from repro_torch.models.transformer.model import batch_axes

    for p in params.parameters():
        p.grad = None
    loss = loss_fn(params, cfg, batch, mesh=mesh)
    loss.backward()
    if mesh is not None:
        reduce_gradients(params, specs, mesh,
                         batch_axes(mesh, batch["tokens"].shape[0]))
    return loss.detach(), {n: p.grad for n, p in params.named_parameters()}


def timed_call(fn):
    """``(fn(), seconds)`` with the card (if any) synchronised around the
    call."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _expert_bank(name: str) -> bool:
    return name.rsplit(".", 2)[-2:-1] == ["moe"] and name.endswith(
        (".w_gate", ".w_up", ".w_down"))


def sharded_lm_part(dev, mesh, card: str) -> dict:
    """Phase 18 (a): see the module docstring."""
    import torch

    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_params
    from repro_torch.models.transformer.moe import moe_schedule
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train.tree import trainable

    cfg = sharded_lm_cfg()
    params = trainable(init_params(cfg, device=dev,
                                   generator=torch.Generator(dev).manual_seed(0)))
    batch = lm_train_batch(dev, 1, 4, cfg.vocab_size, SHARDED_S)
    specs = lm_param_specs(params, cfg, mesh)
    sharded = shard_tree(params, specs, mesh)  # one rank: views of the same storage
    check(moe_schedule(cfg, mesh, SHARDED_S) == "expert_tp",
          "a one-rank mesh runs the MoE layer on the expert-TP schedule")
    weights_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    # One gradient set on the card at a time beside the weights: the
    # meshless one waits on the host.
    loss_ref, grads = lm_grads(params, cfg, batch)  # also the warm-up
    ref = {n: g.detach().cpu() for n, g in grads.items()}
    del grads
    (loss_2, grads), plain_s = timed_call(lambda: lm_grads(params, cfg, batch))
    unsteady = sorted(n for n, g in grads.items() if not torch.equal(g, ref[n].to(dev)))
    del grads
    for p in params.parameters():
        p.grad = None
    lm_grads(sharded, cfg, batch, mesh, specs)  # warm-up: the groups' first collectives
    reset_launch_counts()
    (loss_m, grads_m), mesh_s = timed_call(lambda: lm_grads(sharded, cfg, batch, mesh, specs))
    counts = dict(launch_counts)
    check(torch.equal(loss_m, loss_ref) and torch.equal(loss_2, loss_ref),
          f"deepseek sharded loss {float(loss_m)} bit-equal to the meshless {float(loss_ref)}")
    differ, worst = [], 0.0
    for n, want in ref.items():
        got, want = grads_m[n], want.to(dev)
        if n in unsteady:
            err = float((got.float() - want.float()).norm()
                        / want.float().norm().clamp_min(1e-30))
            worst = max(worst, err)
            check(err <= TRAIN_GRAD_TOL, f"{n}: within {TRAIN_GRAD_TOL} in norm ({err})")
        elif not torch.equal(got, want):
            differ.append(n)
        del want
    check(not differ, f"gradients bit-equal to the meshless route's: {differ} differ")
    print(f"sharded train {cfg.name} {cfg.num_dense_layers} dense + 1 MoE ({cfg.moe.num_experts} "
          f"experts) + MTP at full width ({weights_gb} GB of weights), mesh (1, 1) over "
          f"NCCL, B=1 S={SHARDED_S}: loss={float(loss_m)} bit-equal to the meshless loss; "
          f"{len(ref)} gradients, {len(ref) - len(unsteady)} bit-equal, leaves whose "
          f"meshless gradient differs between two meshless runs (held at "
          f"{TRAIN_GRAD_TOL} in norm, worst {worst}): {unsteady}; value_and_grads "
          f"mesh_s={mesh_s} meshless_s={plain_s} launches={counts} [{card}]")
    del ref, grads_m
    # AdamW's two bf16 moments of every leaf would take twice the
    # weights' bytes beside the weights and their gradients: the step
    # updates every leaf but the expert bank, whose gradients go first.
    opt_cfg = AdamWConfig(moment_dtype="bfloat16")
    moments_gb = 2 * weights_gb
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    held_gb = torch.cuda.memory_allocated() / 1e9
    rest = {}
    for n, p in sharded.named_parameters():
        if _expert_bank(n):
            p.grad = None
        else:
            rest[n] = p
    state = init_opt_state(rest, opt_cfg)
    before = sharded.final_norm.detach().clone()
    (_, _, metrics), adam_s = timed_call(lambda: adamw_update(
        {n: p.grad for n, p in rest.items()}, state, rest, opt_cfg))
    check(bool(torch.isfinite(metrics["grad_norm"])) and not torch.equal(
        before, sharded.final_norm.detach()), "the AdamW step moved the parameters")
    print(f"sharded train AdamW step (bf16 moments) on the sharded parameters but the "
          f"expert bank ({len(rest)} leaves): the moments of every leaf need {moments_gb} "
          f"GB; the weights and gradients hold {held_gb} GB, {free_gb} GB is free; "
          f"grad_norm={float(metrics['grad_norm'])} step_s={adam_s} [{card}]")
    del params, sharded, state, rest
    torch.cuda.empty_cache()
    return {"counts": counts, "mesh_s": mesh_s, "plain_s": plain_s, "unsteady": unsteady}


def sharded_mixtral_part(dev, mesh, card: str) -> dict:
    """Phase 18 (b): see the module docstring."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_family import lm_param_specs
    from repro_torch.data.lm import lm_batch
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import (
        forward,
        init_kv_cache,
        init_params,
        serve_step,
    )

    cfg = dataclasses.replace(get_arch("mixtral-8x7b").config, num_layers=4)
    params = init_params(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    sharded = shard_tree(params, lm_param_specs(params, cfg, mesh), mesh)
    tokens = torch.from_numpy(lm_batch(1, SHARDED_MIXTRAL_S, cfg.vocab_size, seed=5)[
        "tokens"]).to(dev)
    with torch.inference_mode():
        forward(params, cfg, tokens)  # warm-up
        want, plain_s = timed_call(lambda: forward(params, cfg, tokens))
        reset_launch_counts()
        got, mesh_s = timed_call(lambda: forward(sharded, cfg, tokens, mesh=mesh))
        counts = dict(launch_counts)
        check(torch.equal(got, want), "mixtral forward(mesh=) logits bit-equal")
        del got, want
        caches = (init_kv_cache(cfg, 1, 64, device=dev),
                  init_kv_cache(cfg, 1, 64, device=dev, mesh=mesh))
        for i in range(SHARDED_DECODE_STEPS):
            a, _ = serve_step(params, cfg, caches[0], tokens[:, i:i + 1], i)
            b, _ = serve_step(sharded, cfg, caches[1], tokens[:, i:i + 1], i, mesh=mesh)
            check(torch.equal(a, b), f"mixtral serve_step(mesh=) logits bit-equal at {i}")
    print(f"sharded forward mixtral-8x7b 4 of 32 layers at full width, mesh (1, 1), B=1 "
          f"S={SHARDED_MIXTRAL_S}: logits bit-equal, {SHARDED_DECODE_STEPS} decode steps "
          f"bit-equal; mesh_s={mesh_s} meshless_s={plain_s} launches={counts} [{card}]")
    del params, sharded, caches
    torch.cuda.empty_cache()
    return {"counts": counts, "mesh_s": mesh_s, "plain_s": plain_s}


def sharded_gnn_part(dev, mesh, ogb: dict, card: str) -> dict:
    """Phase 18 (c): see the module docstring."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import reduce_gradients
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.gnn import gin
    from repro_torch.train.tree import trainable

    graph = gnn_on_card(ogb, dev)
    graph["labels"] = torch.from_numpy(ogb["labels"]).to(dev)
    cfg = get_arch("gin-tu").config_for(GNN_SHAPE)
    params = trainable(gin.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                       device=dev))

    def step(axes):
        for p in params.parameters():
            p.grad = None
        with mesh:
            loss = gin.loss_fn(params, cfg, graph, psum_axes=axes)
        loss.backward()
        reduce_gradients(params, {}, mesh, axes)
        return loss.detach(), [p.grad.clone() for p in params.parameters()]

    # The gathers' gradients (index_select's backward, index_add_ on the
    # card) add in no fixed order unless deterministic algorithms are on.
    torch.use_deterministic_algorithms(True)
    try:
        loss_ref, grads_ref = step(())  # also the warm-up
        step(("data",))  # warm-up
        (_, _), plain_s = timed_call(lambda: step(()))
        reset_launch_counts()
        (loss_m, grads_m), mesh_s = timed_call(lambda: step(("data",)))
        counts = dict(launch_counts)
    finally:
        torch.use_deterministic_algorithms(False)
    names = [n for n, _ in params.named_parameters()]
    differ = [n for n, a, b in zip(names, grads_m, grads_ref) if not torch.equal(a, b)]
    check(torch.equal(loss_m, loss_ref) and not differ,
          f"gin-tu's edge-parallel step bit-equal to the meshless step ({differ} differ)")
    print(f"sharded train gin-tu {GNN_SHAPE} edge-parallel (psum_axes=('data',)), mesh (1, 1), "
          f"deterministic algorithms on: loss={float(loss_m)} and {len(grads_m)} gradients "
          f"bit-equal; step mesh_s={mesh_s} meshless_s={plain_s} launches={counts} [{card}]")
    del graph, params
    torch.cuda.empty_cache()
    return {"counts": counts, "mesh_s": mesh_s, "plain_s": plain_s}


def sharded_small_part(dev, card: str) -> None:
    """Phase 18 (d): see the module docstring."""
    import torch
    import torch.nn.functional as F

    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.ops.sharded_lookup import sharded_row_gather

    gen = torch.Generator(dev).manual_seed(7)
    pod = make_test_mesh((1,), ("pod",))
    w = (torch.randn(1, 2, 256, 256, device=dev, generator=gen) * 0.06).requires_grad_(True)
    xs = torch.randn(4, 64, 256, device=dev, generator=gen).requires_grad_(True)
    layer = lambda x, lp: torch.tanh(x @ lp["w"])  # noqa: E731
    out, pipe_s = timed_call(lambda: pipeline_apply(layer, {"w": w}, xs, pod, "pod"))
    out.square().sum().backward()
    got = (out.detach(), w.grad.clone(), xs.grad.clone())
    w.grad = xs.grad = None
    ys = []
    for x in xs:  # microbatch by microbatch, as the stage runs them
        for i in range(2):
            x = torch.tanh(x @ w[0, i])
        ys.append(x)
    y = torch.stack(ys)
    y.square().sum().backward()
    check(torch.equal(got[0], y.detach()),
          "pipeline_apply on one stage bit-equal to the sequential loop")
    for a, b in zip(got[1:], (w.grad, xs.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    table = torch.randn(32000, 4096, device=dev, generator=gen).to(torch.bfloat16)
    table.requires_grad_(True)
    idx = torch.randint(0, 32000, (1, 4096), device=dev, generator=gen)
    model = make_test_mesh((1, 1))
    rows, gather_s = timed_call(lambda: sharded_row_gather(table, idx, model, "model"))
    rows.float().sum().backward()
    g = table.grad.clone()
    table.grad = None
    want = F.embedding(idx, table)
    want.float().sum().backward()
    check(torch.equal(rows, want), "sharded_row_gather bit-equal to F.embedding")
    torch.testing.assert_close(g, table.grad)
    print(f"sharded pipeline_apply 1 stage x 2 layers (4 microbatches of (64, 256)) and "
          f"sharded_row_gather (32000, 4096) bf16 at (1, 4096): outputs bit-equal, "
          f"gradients within assert_close's float32 / bf16 defaults; "
          f"pipeline_s={pipe_s} gather_s={gather_s} [{card}]")
    resident_experts_check(dev, gen, card)


RESIDENT_EXPERTS, RESIDENT_TOKENS = 16, 8


def resident_experts_widened(tokens, gate_local, p, act):
    """``moe._resident_experts``' plain version: the products of operands
    widened to float32, every resident expert's weights copied to float32
    on each call."""
    import torch

    t32 = tokens.float()
    h = act(torch.einsum("td,edf->tef", t32, p.w_gate.float())) * torch.einsum(
        "td,edf->tef", t32, p.w_up.float())
    y = torch.einsum("tef,efd->ted", h.to(tokens.dtype).float(), p.w_down.float())
    return torch.einsum("ted,te->td", y, gate_local)


def resident_experts_check(dev, gen, card: str) -> None:
    """The psum schedule's expert products (``moe._resident_experts``, the
    MoE layer of a decode on a mesh of several ranks), bf16 operands
    summed and written in float32 by batched GEMMs, against the products
    of the operands widened to float32: deepseek-v3's widths,
    ``RESIDENT_EXPERTS`` resident experts, ``RESIDENT_TOKENS`` tokens.
    The forward within 2^-8 in norm: the same exact products summed in
    another order, so the hidden activations, rounded to bf16 between the
    two GEMMs, may differ by one bf16 step (2^-8 of a value) where the
    two sums straddle a rounding boundary (3.7e-4 on the card). The
    gradients, whose cotangent the GEMMs round to bf16 once, within
    ``TRAIN_GRAD_TOL``."""
    import types

    import torch
    import torch.nn.functional as F

    from repro_torch.models.transformer import moe

    m, d = sharded_lm_cfg().moe, sharded_lm_cfg().d_model
    f, e, t = m.d_ff_expert, RESIDENT_EXPERTS, RESIDENT_TOKENS

    def leaf(*shape, scale):
        x = torch.randn(*shape, device=dev, generator=gen) * scale
        return x.to(torch.bfloat16).requires_grad_(True)

    w = {"w_gate": leaf(e, d, f, scale=d ** -0.5), "w_up": leaf(e, d, f, scale=d ** -0.5),
         "w_down": leaf(e, f, d, scale=f ** -0.5)}
    tokens = leaf(t, d, scale=1.0)
    gate = torch.rand(t, e, device=dev, generator=gen)
    cot = torch.randn(t, d, device=dev, generator=gen)
    p = types.SimpleNamespace(**w)

    def run(fn):
        out = fn(tokens, gate, p, F.silu)
        grads = torch.autograd.grad((out * cot).sum(), [tokens, *w.values()])
        return out.detach(), grads

    run(moe._resident_experts)  # warm-ups
    run(resident_experts_widened)
    (got, got_g), secs = timed_call(lambda: run(moe._resident_experts))
    (want, want_g), plain_s = timed_call(lambda: run(resident_experts_widened))
    with torch.no_grad():
        _, fwd_s = timed_call(lambda: moe._resident_experts(tokens, gate, p, F.silu))
        _, fwd_plain_s = timed_call(lambda: resident_experts_widened(
            tokens, gate, p, F.silu))
    # the forward's least traffic: the weights read once
    bound_s = sum(x.numel() * x.element_size() for x in w.values()) / HBM_BYTES_PER_S
    rel = lambda a, b: float((a.float() - b.float()).norm()  # noqa: E731
                             / b.float().norm().clamp_min(1e-30))
    err, g_err = rel(got, want), max(rel(a, b) for a, b in zip(got_g, want_g))
    check(got.dtype == torch.float32 and err <= 2 ** -8,
          f"the resident experts' float32 products within 2^-8 in norm ({err})")
    check(g_err <= TRAIN_GRAD_TOL,
          f"their gradients within {TRAIN_GRAD_TOL} in norm of the widened route's ({g_err})")
    print(f"sharded psum expert products {e} experts x {t} tokens at d={d} f={f}, "
          f"bf16 GEMMs with float32 output against the widened products: forward in "
          f"norm {err}, gradients worst {g_err}; value_and_grad s={secs} widened_s={plain_s}; "
          f"forward s={fwd_s} widened_s={fwd_plain_s} bound_s={bound_s} (the weights read "
          f"once) [{card}]")


def phase_sharded_train(dev, ogb: dict, card: str) -> dict:
    """Phase 18: (a)-(d) of the module docstring, on one mesh over NCCL.
    Returns the launches of (a)-(c) summed, and each part's times."""
    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    mesh = make_test_mesh((1, 1))
    check(mesh.device.type == "cuda", "the mesh's ranks are on the card")
    parts = {"lm": sharded_lm_part(dev, mesh, card),
             "mixtral": sharded_mixtral_part(dev, mesh, card),
             "gnn": sharded_gnn_part(dev, mesh, ogb, card)}
    sharded_small_part(dev, card)
    counts = {}
    for part in parts.values():
        for k, v in part["counts"].items():
            counts[k] = counts.get(k, 0) + v
    for name in ("flash_attention", "flash_attention.bwd.wmma", "segment_sum"):
        check(counts.get(name, 0) > 0, f"phase 18 launched {name}: {counts}")
    secs = time.perf_counter() - t0
    print(f"sharded phase 18 launches={counts} phase_s={secs} [{card}]")
    return {"counts": counts, "parts": parts, "secs": secs}


# ---------------------------------------------------------------------------
# Phase 19: the last modules -- the dry run, built specs, the examples
# ---------------------------------------------------------------------------

# (a) cells of the dry-run CLI: (arch, shape, mesh).
DRYRUN_CELLS = (("qwen3-4b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "multi"),
                ("gin-tu", "ogb_products", "single"))
# (b) built specs run on the card: (arch, shape).
BUILT_CELLS = (("gin-tu", "ogb_products"), ("mace", "molecule"),
               ("xdeepfm", "train_batch"))
# The caching allocator rounds every block up to a multiple of this
# (``allocator_slack``).
ALLOC_ROUND = 512
# the built step on (1, 1) against the meshless step: every collective a
# copy, so only the order of float32 sums may differ (the CPU tests hold
# the built steps on (2, 2) and (1, 2) at the same figure)
BUILT_TOL = 1e-3
# (c) the examples, each at the reference's default arguments, and the
# hand kernels each must launch (torch_serve_lm decodes token by token,
# which runs no hand kernel, and xDeepFM has none).
EXAMPLES = (
    ("torch_quickstart", (), ("edge_hook.sv2", "edge_hook.sv3", "pointer_jump",
                              "splitter_aggregate")),
    ("torch_serve_lm", (), ()),
    ("torch_train_lm", ("--checkpoint-dir", None), ("flash_attention",
                                                    "flash_attention.bwd.wmma")),
    ("torch_gnn_cora", (), ("segment_sum",)),
    ("torch_recsys_serving", (), ()),
)


def start_dryrun_cli():
    """Phase 19 (a), started: the dry-run CLI on ``DRYRUN_CELLS`` from one
    shell subprocess, the three cells at once (a fake process group is
    process-wide and of one size, so each cell is its own process of the
    CLI). It runs on the host's cores while (b)-(d) run on the card;
    ``dryrun_cli`` waits for it."""
    runs = " ".join(
        f"{sys.executable} -m repro_torch.launch.dryrun --arch {a} --shape {s} "
        f'--mesh {m} --json > "$tmp/{i}" 2>&1 & pids="$pids $!";'
        for i, (a, s, m) in enumerate(DRYRUN_CELLS))
    cat = " ".join(f'"$tmp/{i}"' for i in range(len(DRYRUN_CELLS)))
    cmd = (f'tmp=$(mktemp -d); pids=""; {runs} rc=0; '
           f'for p in $pids; do wait $p || rc=1; done; '
           f'for f in {cat}; do tail -n 1 "$f"; done; rm -rf "$tmp"; exit $rc')
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(["bash", "-c", cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    return proc, time.perf_counter()


def dryrun_cli(started, card: str) -> list:
    """Phase 19 (a), finished: each record printed, and each must be
    ``ok``."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    proc = subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"dry-run CLI failed: {proc.stderr[-3000:]}")
    recs = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    check(len(recs) == len(DRYRUN_CELLS), f"dry-run CLI printed {len(recs)} records")
    for (a, s, m), rec in zip(DRYRUN_CELLS, recs):
        check((rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (a, s, m, "ok"),
              f"dry-run record {rec}")
        roof = rec["roofline"]
        print(f"dryrun {a} {s} {m}: chips={rec['chips']} lower_s={rec['lower_s']} "
              f"bottleneck={roof['bottleneck']} compute_s={roof['compute_s']} "
              f"memory_s={roof['memory_s']} collective_s={roof['collective_s']} "
              f"memory_per_device={roof['memory_per_device']} "
              f"collective_bytes={roof['collectives']['bytes_by_op']} "
              f"(analytic H100 figures, not measurements) [{card}]")
        print(f"dryrun record: {json.dumps(rec)}")
    print(f"dryrun CLI: {len(recs)} cells in one subprocess, wall_s={secs} (beside "
          f"(b)-(d) on the card) [{card}]")
    return recs


def built_inputs(arch, shape: str, spec, dev, ogb: dict):
    """The arguments of a built spec made on the card: the model's own
    init (seeded), zero AdamW moments, and the batch from a seeded
    generator to the spec's shapes with ids in range (destinations and
    graph ids sorted, as the data pipeline gives them; no self-loops);
    gin-tu's graph is phase 11's ogb_products."""
    import torch

    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.train.optimizer import init_opt_state

    gen = torch.Generator(dev).manual_seed(19)
    if arch.family == "gnn":
        cfg = arch.config_for(shape)
        params = arch.module.init_params(cfg, device=dev, generator=gen)
        info = GNN_SHAPES[shape]
        n, graphs = info["n"], info.get("graphs", 1)
        batch = {}
        for key, leaf in spec.args[2].items():
            if key in ogb and shape == "ogb_products":
                batch[key] = torch.from_numpy(np.ascontiguousarray(ogb[key])).to(
                    dev, leaf.dtype)
            elif key == "dst":
                batch[key] = torch.sort(torch.randint(0, n, leaf.shape, generator=gen,
                                                      device=dev))[0].to(leaf.dtype)
            elif key == "graph_ids":
                batch[key] = torch.sort(torch.randint(0, graphs, leaf.shape, generator=gen,
                                                      device=dev))[0].to(leaf.dtype)
            elif key == "species":
                batch[key] = torch.randint(0, getattr(cfg, "num_species", 10), leaf.shape,
                                           generator=gen,
                                           device=dev).to(leaf.dtype)
            elif key == "labels" and not leaf.dtype.is_floating_point:
                batch[key] = torch.randint(0, cfg.num_classes, leaf.shape, generator=gen,
                                           device=dev).to(leaf.dtype)
            elif leaf.dtype.is_floating_point:
                batch[key] = torch.randn(leaf.shape, generator=gen, device=dev)
            else:
                batch[key] = None  # src, after dst
        if batch.get("src") is None:
            hop = torch.randint(1, n, batch["dst"].shape, generator=gen, device=dev)
            batch["src"] = ((batch["dst"].long() + hop) % n).to(torch.int32)
        batch = {k: batch[k] for k in spec.args[2]}
        return params, init_opt_state(params, arch.opt_config()), batch
    from repro_torch.models.recsys import xdeepfm as xm

    cfg = arch.config
    params = xm.init_params(cfg, device=dev, generator=gen)
    leaf = spec.args[2]["sparse_ids"]
    batch = {"sparse_ids": torch.randint(0, cfg.vocab_per_field, leaf.shape,
                                         generator=gen, device=dev).to(leaf.dtype),
             "labels": torch.randint(0, 2, spec.args[2]["labels"].shape,
                                     generator=gen, device=dev).to(torch.int32)}
    return params, init_opt_state(params, arch.opt_config()), batch


def meshless_step(arch, shape: str, params, batch):
    """One ``make_train_step`` of ``arch``'s meshless loss from
    ``params`` (moved in place) on the whole batch; returns the loss."""
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_opt_state

    if arch.family == "gnn":
        cfg = arch.config_for(shape)
        graphs = GNN_SHAPES[shape].get("graphs", 1)

        def loss(p, g):
            return arch.module.loss_fn(p, cfg, dict(g, num_graphs=graphs))
    else:
        from repro_torch.models.recsys import xdeepfm as xm

        def loss(p, b):
            return xm.loss_fn(p, arch.config, b)
    opt_cfg = arch.opt_config()
    step = make_train_step(loss, opt_cfg)
    _, _, _, metrics = step(params, init_opt_state(params, opt_cfg), None, batch)
    return float(metrics["loss"])


def allocator_slack(tree) -> int:
    """The most bytes the caching allocator can hold beyond an argument
    tree's own: each block is its size rounded up to ``ALLOC_ROUND``, and
    a block over 1 MiB also keeps the rest of its segment when that rest
    is 1 MiB or less (it is not split off)."""
    return sum(ALLOC_ROUND - 1 + (1 << 20 if t.numel() * t.element_size() > 1 << 20 else 0)
               for t in _tensors(tree))


def built_specs(dev, ogb: dict, card: str) -> dict:
    """Phase 19 (b): each of ``BUILT_CELLS``' specs, built for a (1, 1)
    mesh over NCCL, run once on arguments made on the card: the loss
    finite, ``segment_sum`` launched by the GNNs, the step's wall ms,
    and the bytes the arguments take on the card against the dry run's
    per-rank argument bytes for the same cell: the allocator's requested
    bytes equal to the byte, and ``memory_allocated`` above them by no
    more than its rounding (``allocator_slack``); and the loss and each
    parameter's update against ``meshless_step`` from the same
    arguments, within ``BUILT_TOL``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.common import bytes_per_rank, shard_args
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((1, 1))
    counts = {}
    for name, shape in BUILT_CELLS:
        arch = get_arch(name)
        spec = arch.build(shape, mesh)
        dry = bytes_per_rank(spec.args, spec.in_specs, mesh)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        asked = torch.cuda.memory_stats()["requested_bytes.all.current"]
        args = built_inputs(arch, shape, spec, dev, ogb)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        asked = torch.cuda.memory_stats()["requested_bytes.all.current"] - asked
        check(bytes_per_rank(args, spec.in_specs, mesh) == dry,
              f"{name} {shape}: the made arguments are the spec's shapes")
        check(asked == dry, f"{name} {shape}: requested {asked} != the dry run's {dry}")
        slack = allocator_slack(args)
        check(0 <= held - dry <= slack,
              f"{name} {shape}: allocated {held} not within the allocator's rounding "
              f"({slack} bytes) of the dry run's {dry}")
        # the meshless step's parameters, apart (on (1, 1) the blocks are
        # views of the arguments, which the built step moves)
        ref = copy.deepcopy(args[0])
        start = {n: p.detach().clone() for n, p in args[0].named_parameters()}
        local = shard_args(args, spec.in_specs, mesh)
        reset_launch_counts()
        t0 = time.perf_counter()
        with mesh:
            _, _, loss = spec.fn(*local)
        loss = float(loss)
        secs = time.perf_counter() - t0
        launched = dict(launch_counts)
        check(math.isfinite(loss), f"{name} {shape}: loss {loss}")
        want = meshless_step(arch, shape, ref, args[2])
        moved = dict(ref.named_parameters())
        errs = {n: float((p.detach() - moved[n].detach()).norm()
                         / (moved[n].detach() - start[n]).norm().clamp_min(1e-30))
                for n, p in local[0].named_parameters()}
        worst = max(errs, key=errs.get)
        loss_err = abs(loss - want) / max(abs(want), 1e-30)
        check(loss_err <= BUILT_TOL, f"{name} {shape}: loss {loss} against the meshless {want}")
        check(errs[worst] <= BUILT_TOL,
              f"{name} {shape}: {worst} moved {errs[worst]} in norm from the meshless step")
        del ref, start, moved
        if arch.family == "gnn":
            check(launched["segment_sum"] > 0, f"{name} {shape}: {launched}")
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
        print(f"built {name} {shape} on mesh (1, 1) NCCL: loss={loss} step_ms={secs * 1e3} "
              f"segment_sum_launches={launched['segment_sum']} "
              f"memory_allocated={held} requested_bytes={asked} "
              f"dryrun_argument_size_in_bytes={dry} (allocated - dry run = "
              f"{held - dry} bytes of rounding over {len(_tensors(args))} "
              f"tensors, at most {slack}); against the meshless step: loss {want} "
              f"(rel_err {loss_err}), parameter updates in norm worst {errs[worst]} "
              f"({worst}) of {len(errs)} leaves [{card}]")
        del args, local
    return counts


def _tensors(tree):
    import torch

    from repro_torch.train.tree import leaves

    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def run_examples(card: str) -> dict:
    """Phase 19 (c): the five examples in this process through their
    ``main(argv)`` at the reference's default arguments on the card
    (each checks itself); each one's hand-kernel launches counted from 0
    and printed, those ``EXAMPLES`` names above 0."""
    import importlib.util
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launch_counts

    counts = {}
    for name, argv, needs in EXAMPLES:
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with tempfile.TemporaryDirectory() as tmp:
            args = [tmp if a is None else a for a in argv]
            reset_launch_counts()
            t0 = time.perf_counter()
            mod.main(list(args))
            secs = time.perf_counter() - t0
        launched = {k: v for k, v in launch_counts.items() if v}
        for k in needs:
            check(launched.get(k, 0) > 0, f"{name} launched {k}: {launched}")
        for k, v in launched.items():
            counts[k] = counts.get(k, 0) + v
        print(f"example {name} {' '.join(args)}: wall_s={secs} launches={launched} [{card}]")
    return counts


def traced_quickstart(dev, card: str) -> dict:
    """Phase 19 (d): one traced ``torch_quickstart``-sized CC call,
    exported with ``export_chrome`` and summarised with ``summarize
    --require cc.frontier``; returns its launches."""
    import tempfile

    from repro_torch.core import connected_components
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import summarize, trace
    from repro_torch.ops.kiss import random_forest

    n = 500_000
    edges = random_forest(n, num_components=40, seed=3)
    trace.configure(trace="on")
    trace.reset()
    reset_launch_counts()
    try:
        labels, _ = connected_components(edges[:, 0], edges[:, 1], n, device=dev)
        launched = {k: v for k, v in launch_counts.items() if v}
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/cc_trace.json"
            events = trace.export_chrome(path)
            rc = summarize.main([path, "--require", "cc.frontier"])
    finally:
        trace.configure(trace="off")
        trace.reset()
    check(rc == 0, "summarize --require cc.frontier failed")
    check(int(labels.unique().numel()) == 40, "the traced CC call's components")
    check(launched.get("edge_hook.sv2", 0) > 0, f"the traced CC call's launches {launched}")
    print(f"traced cc n={n}: {events} events exported, summarize --require "
          f"cc.frontier rc={rc}, launches={launched} [{card}]")
    return launched


def phase_slice16(dev, ogb: dict, card: str) -> dict:
    """Phase 19: (a)-(d) of the module docstring. Returns the launches of
    (b)-(d) by kernel and the phase's seconds."""
    t0 = time.perf_counter()
    started = start_dryrun_cli()
    try:
        counts = built_specs(dev, ogb, card)
        for part in (run_examples(card), traced_quickstart(dev, card)):
            for k, v in part.items():
                counts[k] = counts.get(k, 0) + v
    finally:
        recs = dryrun_cli(started, card)
    secs = time.perf_counter() - t0
    print(f"slice 16 phase 19 launches={counts} phase_s={secs} [{card}]")
    return {"counts": counts, "secs": secs, "dryrun": recs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import AUTO_SAMPLE_ROUNDS
    from repro_torch.data.graphs import full_graph, molecule_batch, sampled_minibatch
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    start = time.perf_counter()

    def stamp(phase: str) -> None:
        print(f"phase {phase} starts at_s={time.perf_counter() - start}", flush=True)
    # Float32 products in full float32 (no TF32), for the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # Phase 1: build every kernel, one nvcc per source, all at once.
    t0 = time.perf_counter()
    build.build()
    print(f"build_s={time.perf_counter() - t0} ({len(build.SOURCES)} sources, one nvcc "
          f"each, in parallel) nvcc {' '.join(build.NVCC_FLAGS)}")
    for name in build.SOURCES:
        print(f"ptxas {name}:\n{build.ptxas_report(name)}")
    check_attention_build()
    t0 = time.perf_counter()
    ogb = full_graph(GNN_N, GNN_M, GNN_D, GNN_CLASSES, seed=0)
    print(f"gnn graph full_graph({GNN_N}, {GNN_M}, {GNN_D}, {GNN_CLASSES}, "
          f"seed=0): host_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    minibatch = sampled_minibatch(**MINIBATCH_LG, sort_device=dev)
    print(f"gnn graph sampled_minibatch({MINIBATCH_LG}) (CSR sorted on the card): "
          f"n={len(minibatch['graph_ids'])} m={len(minibatch['src'])} "
          f"host_s={time.perf_counter() - t0}")
    molecules = {b: molecule_batch(b) for b in (MOLECULE_BATCH, MOLECULE_BIG)}
    slice11_cases = slice11_segsum_cases(dev, minibatch, molecules[MOLECULE_BIG])

    graphs = cc_graphs()
    (_, giant, _), (_, rand, _), (_, dense, _) = graphs
    g = max(2, int(CC_GIANT_N * 0.9))
    counts = {}
    for name, edges, n in (("random", rand, CC_RANDOM_N),
                           ("random_dense", dense, CC_DENSE_N)):
        t0 = time.perf_counter()
        counts[name] = components_by_propagation(edges[:, 0], edges[:, 1], n)
        print(f"{name} graph: m/n={len(edges) / n} numpy propagation "
              f"count={counts[name]} host_s={time.perf_counter() - t0}")

    stamp("2")
    # Phase 2: kernels against their plain versions.
    errs, hook_inputs, pj_inputs, agg_inputs = phase_kernels(
        dev, graphs, LIST_N, SPLITTERS, POINTER_JUMP_BIG_P, "cuda")
    sssp_w = sssp_weights(len(rand))
    errs["ordered_fold"], of_inputs = phase_ordered_fold(dev, rand, CC_RANDOM_N,
                                                         sssp_w)
    errs["segment_sum"] = phase_segment_sum(dev, ogb["dst"])
    phase_segment_sum_slice11(dev, slice11_cases)
    phase_segment_ops(dev)
    moe_combine_err = phase_segment_sum_moe(dev)

    stamp("3")
    # Phases 3 and 4: the main path, launches counted from 0 in each run.
    check_sample_table(dev, dense[:, 0], dense[:, 1], CC_DENSE_N,
                       AUTO_SAMPLE_ROUNDS)
    cc_counts, cc_rows = phase_cc(dev, [
        ("giant_dust", giant[:, 0], giant[:, 1], CC_GIANT_N,
         CC_GIANT_N - g + 1, 0),
        ("random", rand[:, 0], rand[:, 1], CC_RANDOM_N, counts["random"], 0),
        ("random_dense", dense[:, 0], dense[:, 1], CC_DENSE_N,
         counts["random_dense"], AUTO_SAMPLE_ROUNDS),
    ], wall_s)
    list_counts, list_secs, walk_share = phase_list(dev, LIST_N, wall_s)

    stamp("5")
    # Phase 5: times.
    times = kernel_times(hook_inputs, pj_inputs, agg_inputs, SPLITTERS,
                         POINTER_JUMP_BIG_P, "cuda")
    launches = {k: cc_counts[k] + list_counts[k] for k in cc_counts}
    floor_ms = pointer_jump_floor_ms(*pj_inputs[SPLITTERS])
    print(f"time pointer_jump floor p={SPLITTERS}: ms={floor_ms} (launch, loads, "
          f"stores and {2 * math.ceil(math.log2(SPLITTERS))} barriers, no gathers) "
          f"[{card}]")
    step_floor = pointer_jump_step_floor_ms(POINTER_JUMP_BIG_P)
    print(f"time pointer_jump step path floor p={POINTER_JUMP_BIG_P}: ms={step_floor} "
          f"({math.ceil(math.log2(POINTER_JUMP_BIG_P))} dependent step launches on "
          f"one node) bound_ms={16 * POINTER_JUMP_BIG_P / HBM_BYTES_PER_S * 1e3} "
          f"[{card}]")
    for name, calls in record_hook_calls(graphs, dev).items():
        sums = hook_cell_sums(hook_call_times(calls))
        print(f"time edge_hook cc {name}: " + " ".join(
            f"{mode} calls={k} ms={ms} bound_ms={bound} share_of_bound={bound / ms}"
            for mode, (k, ms, bound) in sorted(sums.items())) + f" [{card}]")
        del calls
    of_ms, of_plain, of_eager, of_lib, of_bound = ordered_fold_times(of_inputs, card)
    del graphs, giant, dense, hook_inputs, pj_inputs, agg_inputs, of_inputs
    torch.cuda.empty_cache()
    ss_times = segment_sum_times(dev, ogb["dst"])

    stamp("6")
    # Phases 6-10: the LM.
    lm = phase_lm(dev)
    launches["flash_attention"] = lm["counts"]["flash_attention"]

    stamp("11")
    # Phase 11: GNN inference, launches counted from 0 in each cell.
    gnn = phase_gnn(dev, ogb)
    launches["segment_sum"] = sum(cell[-1] for cell in gnn.values())

    stamp("12")
    # Phase 12: graph analytics, launches counted from 0 in each checked run.
    ga = phase_graph_analytics(dev, rand, CC_RANDOM_N, sssp_w, wall_s)
    launches["ordered_fold"] = ga["pagerank"][2]

    stamp("13")
    # Phase 13: graph serving, launches counted over the served streams.
    serving = phase_serve_graphs(dev, card)
    for name, count in serving["launches"].items():
        launches[name] = launches.get(name, 0) + count

    stamp("14")
    # Phase 14: the sharded graph engine over NCCL at world size 1,
    # launches counted over its checked runs.
    sharded = phase_sharded(dev, card, list_secs)
    for name, count in sharded["launches"].items():
        launches[name] = launches.get(name, 0) + count

    stamp("15")
    # Phase 15: the rest of GNN and RecSys inference, launches counted
    # from 0 in each cell.
    slice11 = phase_slice11(dev, ogb, minibatch, molecules, slice11_cases)
    del minibatch, molecules, slice11_cases
    launches["segment_sum"] += sum(cell["launches"] for cell in slice11["cells"])

    stamp("16")
    # Phase 16: MoE, MLA and the MTP head, launches counted from 0 in each
    # model's timed prefill (and the MTP call).
    moe = phase_moe(dev, card)
    for cell in moe["cells"].values():
        for name in ("flash_attention", "segment_sum"):
            launches[name] += cell["counts"][name]
    launches["flash_attention"] += moe["cells"]["deepseek-v3-671b"]["mtp_launches"]

    stamp("17")
    # Phase 17: single-device training; launches counted from 0 in each
    # train() run.
    t17 = time.perf_counter()
    bwd_errs = phase_attention_bwd(dev)
    bwd_times = {"wgmma": attention_bwd_times(dev, card),
                 "wmma": attention_bwd_times(dev, card, TRAIN_MLA_ATTN, dv=128)}
    train_lm = phase_train_lm(dev, card)
    train_mla = phase_train_mla(dev, card)
    train_gnn = phase_train_gnn(dev, ogb, card)
    train_secs = time.perf_counter() - t17

    stamp("18")
    # Phase 18: sharded training over NCCL at world size 1; launches
    # counted from 0 in each part's mesh run.
    sharded_train = phase_sharded_train(dev, ogb, card)
    stamp("19")

    # Phase 19: the last modules; launches counted from 0 in each built
    # step, each example and the traced CC call.
    slice16 = phase_slice16(dev, ogb, card)
    del ogb
    for name, count in slice16["counts"].items():
        if name in launches:
            launches[name] += count
    launches["flash_attention"] += train_lm["counts"]["flash_attention"]
    launches["segment_sum"] += train_gnn["counts"]["segment_sum"]
    launches["segment_sum"] += sharded_train["counts"].get("segment_sum", 0)
    mixtral_fa = sharded_train["parts"]["mixtral"]["counts"].get("flash_attention", 0)
    launches["flash_attention"] += mixtral_fa
    errs["flash_attention"] = lm["max_abs_err"]
    records = []
    for name, (ms, plain_ms, eager_ms, nbytes) in times.items():
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"time {name}: ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} "
              f"bytes={nbytes} share_of_bound={bound_ms / ms} "
              f"eager_ms={eager_ms} eager_minus_graph_ms={eager_ms - ms} "
              f"[{card}]")
        if name not in KERNELS:
            continue
        source, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })
    print("library_ms: n/a for the three graph kernels -- no single "
          "PyTorch call computes an SV hook phase, a pointer-jumping run or "
          "the RS5 aggregation")
    fa_ms, fa_plain, fa_eager, fa_sdpa, fa_bound = lm["times"]
    records.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": KERNELS["flash_attention"][1],
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "ms": fa_ms,
        "plain_ms": fa_plain, "bound_ms": fa_bound, "bound_by": "operations",
        "library_ms": fa_sdpa,
    })
    print(f"time flash_attention (record): ms={fa_ms} eager_ms={fa_eager} "
          f"plain_ms={fa_plain} library_ms(sdpa)={fa_sdpa} bound_ms={fa_bound} "
          f"[{card}]")
    ss_ms, ss_plain, ss_eager, ss_lib, ss_bound = ss_times
    records.append({
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": KERNELS["segment_sum"][1],
        "launches": launches["segment_sum"],
        "max_abs_err": errs["segment_sum"], "ms": ss_ms,
        "plain_ms": ss_plain, "bound_ms": ss_bound, "bound_by": "bytes",
        "library_ms": ss_lib,
    })
    print(f"time segment_sum (record, {GNN_SHAPE} (m, {GNN_D}) float32): "
          f"ms={ss_ms} eager_ms={ss_eager} plain_ms={ss_plain} "
          f"library_ms(segment_reduce)={ss_lib} bound_ms={ss_bound} [{card}]")
    # Phase 16's shapes: the MLA instance and the two MoE combines, each
    # with its launches in phase 16's timed prefill (and the MTP call).
    ds = moe["cells"]["deepseek-v3-671b"]
    mla_ms, mla_plain, mla_eager, mla_sdpa, mla_bound = moe["times"]["mla"]
    records.append({
        "name": "flash_attention.mla_192_128", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": KERNELS["flash_attention"][1],
        "launches": (ds["counts"]["flash_attention"] + ds["mtp_launches"]
                     + sharded_train["counts"]["flash_attention"] - mixtral_fa),
        "max_abs_err": lm["mla_err"], "ms": mla_ms, "plain_ms": mla_plain,
        "bound_ms": mla_bound, "bound_by": "operations", "library_ms": mla_sdpa,
    })
    print(f"time flash_attention MLA (record, B=1 H={MLA_HEADS} S={MLA_S} D=192 Dv=128): "
          f"ms={mla_ms} eager_ms={mla_eager} plain_ms={mla_plain} "
          f"library_ms(sdpa)={mla_sdpa} bound_ms={mla_bound} [{card}]")
    for name, t, k, d in MOE_COMBINES:
        c_ms, c_plain, c_eager, c_lib, c_bound = moe["times"][name]
        records.append({
            "name": f"segment_sum.moe_combine_{name.split('-')[0]}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
            "replaces": KERNELS["segment_sum"][1],
            "launches": moe["cells"][name]["counts"]["segment_sum"],
            "max_abs_err": moe_combine_err, "ms": c_ms, "plain_ms": c_plain,
            "bound_ms": c_bound, "bound_by": "bytes", "library_ms": c_lib,
        })
        print(f"time segment_sum MoE combine (record, {name} ({t * k}, {d}) bf16): "
              f"ms={c_ms} eager_ms={c_eager} plain_ms={c_plain} "
              f"library_ms(segment_reduce)={c_lib} bound_ms={c_bound} [{card}]")
    # The backward's two designs: wgmma at qwen3-4b's training shape (its
    # launches in phase 17 (b)'s train()), wmma at MLA's (its launches in
    # phase 17 (e)'s step).
    for design, name, shape, launched in (
            ("wgmma", "flash_attention.bwd", ATTN_BWD_SHAPE, train_lm["counts"]),
            ("wmma", "flash_attention.bwd.wmma", TRAIN_MLA_ATTN, train_mla["counts"])):
        ms, plain_ms, lib_ms, bound_ms = bwd_times[design]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": KERNELS["flash_attention"][1],
            "launches": (launched[name] + sharded_train["counts"].get(name, 0)
                         + slice16["counts"].get(name, 0)),
            "max_abs_err": bwd_errs[design], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations", "library_ms": lib_ms,
        })
        b_, hq_, hkv_, s_, d_ = shape
        print(f"time {name} (record, {design} design, B={b_} Hq={hq_} Hkv={hkv_} S={s_} "
              f"D={d_}{' Dv=128' if design == 'wmma' else ''} bf16 causal): ms={ms} "
              f"plain_ms={plain_ms} library_ms(sdpa backward)={lib_ms} "
              f"bound_ms={bound_ms} share_of_bound={bound_ms / ms} [{card}]")
    print("flash_attention.bwd has no Pallas counterpart: the reference takes the VJP "
          "of _attn_kernel's function by autodiff")
    records.append({
        "name": "ordered_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ordered_fold.cu",
        "replaces": "src/repro/core/operators.py:96",
        "launches": launches["ordered_fold"],
        "max_abs_err": errs["ordered_fold"], "ms": of_ms, "plain_ms": of_plain,
        "bound_ms": of_bound, "bound_by": "bytes", "library_ms": of_lib,
    })
    print(f"time ordered_fold (record, pagerank's fused mass step, n={CC_RANDOM_N}): "
          f"ms={of_ms} eager_ms={of_eager} plain_ms={of_plain} (events around "
          f"Python calls) library_ms(index_add of the values written out, atomics "
          f"in no fixed order)={of_lib} bound_ms={of_bound} "
          f"share_of_bound={of_bound / of_ms} [{card}]")
    print("ordered_fold has no Pallas counterpart: it replaces the slot-order "
          "scatter-add of the reference's ADD monoid (operators.py:96)")
    for name, secs in cc_rows:
        print(f"e2e connected_components {name}: wall_s={secs} [{card}]")
    print(f"e2e list_rank n={LIST_N}: wall_s={list_secs} "
          f"rs3_walk_share={walk_share} [{card}]")
    print(f"e2e prefill {LM_ARCH} B={PREFILL_B} S={PREFILL_S}: "
          f"wall_ms={lm['prefill_s'] * 1e3} tokens_per_s={lm['prefill_tps']} "
          f"peak_memory_gb={lm['prefill_peak_gb']} "
          f"device_idle_share={lm['prefill_idle']} [{card}]")
    for (slots, max_len, n, _), (tps, steps, ms_step, peak, idle) in zip(
            SERVE_CELLS, lm["serving"]):
        print(f"e2e serve {LM_ARCH} slots={slots} max_len={max_len} {n} requests "
              f"x {SERVE_NEW} tokens: decode_tokens_per_s={tps} steps={steps} "
              f"ms_per_step={ms_step} peak_memory_gb={peak} "
              f"device_idle_share={'not profiled' if idle is None else idle} [{card}]")
    for (name, shape), (secs, eps, peak, idle, n_launch) in gnn.items():
        print(f"e2e gnn {name} {shape}: wall_ms={secs * 1e3} edges_per_s={eps} "
              f"peak_memory_gb={peak} segment_sum_launches={n_launch} "
              f"device_idle_share={'not profiled' if idle is None else idle} "
              f"[{card}]")
    for label, (secs, rounds) in ga["sssp"].items():
        print(f"e2e shortest_paths {label} n={CC_RANDOM_N}: wall_s={secs} "
              f"rounds={rounds} [{card}]")
    pr_s, pr_iters, pr_launches, pr_idle, fixed_s, fixed_launches = ga["pagerank"]
    print(f"e2e pagerank n={CC_RANDOM_N}: wall_s={pr_s} iterations={pr_iters} "
          f"ordered_fold_launches={pr_launches} device_idle_share={pr_idle} [{card}]")
    print(f"e2e pagerank dense n={CC_RANDOM_N}: wall_s={fixed_s} "
          f"ordered_fold_launches={fixed_launches} [{card}]")
    for fam, rep_ in ga["trees"].items():
        print(f"e2e tree_analytics {fam} n={rep_['n']}: splitter_s="
              f"{rep_['tree_analytics_splitter_s']} wylie_s="
              f"{rep_['tree_analytics_wylie_s']} stages={rep_['stages']} "
              f"device_idle_share={rep_.get('idle', 'not profiled')} [{card}]")
    for row in serving["rows"]:
        if "idle" in row:
            print(f"e2e serve_graphs {row['label']} {row['budget']}: "
                  f"device_idle_share={row['idle']} [{card}]")
            continue
        print(f"e2e serve_graphs {row['label']} {row['budget']} "
              f"{row['requests']} requests: requests_per_s={row['rps']} "
              f"wall_s={row['secs']} waves={row['waves']} "
              f"median_wave_ms={row['wave_ms']} "
              f"hand_launches_per_wave={row['launches_per_wave']} "
              f"peak_memory_gb={row['peak_gb']} [{card}]")
    print(f"e2e serve_graphs phase_s={serving['secs']} [{card}]")
    for label, secs, single in sharded["rows"]:
        if label.startswith("nccl share"):
            print(f"e2e sharded {label}: nccl_share_of_busy={secs} "
                  f"device_idle_share={single} [{card}]")
            continue
        print(f"e2e sharded {label} (world size 1, NCCL): wall_s={secs} "
              f"single_device_s={single} [{card}]")
    print(f"e2e sharded phase_s={sharded['secs']} [{card}]")
    for name, (ms, plain_ms, _, lib_ms, bound_ms) in slice11["times"]:
        print(f"time segment_sum slice 11 {name}: ms={ms} plain_ms={plain_ms} "
              f"segment_reduce_ms={lib_ms} bound_ms={bound_ms} "
              f"share_of_bound={bound_ms / ms} [{card}]")
    for cell in slice11["cells"]:
        if cell["secs"] is None:
            continue
        print(f"e2e {cell['label']}: wall_ms={cell['secs'] * 1e3} "
              f"{cell['unit']}={cell['rate']} peak_memory_gb={cell['peak_gb']} "
              f"segment_sum_launches={cell['launches']} device_idle_share="
              f"{'not profiled' if cell['idle'] is None else cell['idle']} [{card}]")
    print(f"e2e slice 11 phase_s={slice11['secs']} [{card}]")
    for name, cell in moe["cells"].items():
        tps, steps, ms_step, peak, idle = cell["serving"]
        print(f"e2e prefill {cell['label']} B=1 S={dict((c[0], c[2]) for c in MOE_CELLS)[name]}: "
              f"wall_ms={cell['prefill_s'] * 1e3} tokens_per_s={cell['tps']} "
              f"peak_memory_gb={cell['peak_gb']} device_idle_share={cell['idle']} "
              f"launches={cell['counts']} [{card}]")
        print(f"e2e serve {cell['label']} slots={MOE_SERVE_SLOTS} "
              f"{MOE_SERVE_REQUESTS} requests x {SERVE_NEW} tokens: "
              f"decode_tokens_per_s={tps} steps={steps} ms_per_step={ms_step} "
              f"peak_memory_gb={peak} device_idle_share={idle} [{card}]")
        if "mtp_s" in cell:
            print(f"e2e mtp {cell['label']}: wall_ms={cell['mtp_s'] * 1e3} [{card}]")
        print(f"e2e prefill vs decode {name}: max_abs_diff={cell['consistency']} [{card}]")
    print(f"e2e moe phase_s={moe['secs']} [{card}]")
    print(f"e2e train {LM_ARCH} {TRAIN_LM_LAYERS} layers B=1 S={TRAIN_LM_S}: "
          f"step_ms={train_lm['step_s'] * 1e3} tokens_per_s={train_lm['tps']} "
          f"peak_memory_gb={train_lm['peak_gb']} device_idle_share={train_lm['idle']} "
          f"attention_bwd_share_of_busy={train_lm['bwd_share']} "
          f"loss_first={train_lm['losses'][0]} loss_last={train_lm['losses'][-1]} [{card}]")
    print(f"e2e train gin-tu {GNN_SHAPE}: step_ms={train_gnn['step_s'] * 1e3} "
          f"edges_per_s={train_gnn['eps']} peak_memory_gb={train_gnn['peak_gb']} "
          f"loss_first={train_gnn['losses'][0]} loss_last={train_gnn['losses'][-1]} [{card}]")
    print(f"e2e train {TRAIN_MLA_ARCH} dense layers + MTP B=1 S={TRAIN_MLA_S}: "
          f"value_and_grads_ms={train_mla['step_s'] * 1e3} [{card}]")
    print(f"e2e train phase_s={train_secs} (lm {train_lm['secs']}, mla {train_mla['secs']}, gnn "
          f"{train_gnn['secs']}) [{card}]")
    for label, part in sharded_train["parts"].items():
        print(f"e2e sharded train {label} (mesh (1, 1), NCCL): mesh_s={part['mesh_s']} "
              f"meshless_s={part['plain_s']} [{card}]")
    print(f"e2e sharded train phase_s={sharded_train['secs']} [{card}]")
    print(f"e2e slice 16 phase_s={slice16['secs']} [{card}]")
    print(f"chip_smoke total_s={time.perf_counter() - start}")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
