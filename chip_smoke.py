#!/usr/bin/env python3
"""Chip check of the PyTorch port (gnn_computing_tpu_torch) on one CUDA card.

Run from the repository root:  python3 chip_smoke.py [--scale quick|reddit]

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit; build every kernel with nvcc (sm_90a), one
     nvcc per source, all at once (B1 bcsr_spmm, B2 gat_bcsr and
     gat_bcsr_factored, B5 rowmax_bcsr, B3 gat_bwd_dad, B4 gat_bwd_dh_das,
     B6 sddmm_bcsr, each with an int8, a 1-bit, a float32 and a bfloat16
     entry point; R1 residual_spmm, the hybrid op's residual; P1
     task_sums; P2 fused_hybrid).
  2. kernel phase: the B1 kernel against its plain PyTorch version on the
     card, at the main path's shapes (f = 128, 64, 32; 'split' and float32
     operands; pack 1 and 16), plus a ragged n with runs made only of filler
     tiles and a factored plan.  Check: max|kernel - plain| <= 1e-5 *
     max|plain| on nonnegative and signed operands, and the ops/validate
     gate on the nonnegative ones.
  3. slice phase: the main path of bench.py — RMAT graph (seed 123, degree
     sorted), int8 [512, 256] tiles at threshold 48, 4-slot residual, the
     3-layer 512 -> 128 -> 64 -> 32 GCN forward with fast_layer_opts and
     Glorot weights (numpy seed 0) carried through convert.py.  Five
     forwards; B1 must launch 3 times per forward.  Each layer's
     aggregation must pass the gate against a float64 edge-list oracle
     (index_add_) of the function its numeric modes define, from the same
     transform output; against the
     unrounded oracle, per layer and for the whole chain, at most
     PURE_BAD_FRACTION of the elements may miss the gate.
  4. timing (CUDA events, median): forward and per-layer ms; per layer
     shape B1 ms, its bound, the plain version's ms and torch.sparse.mm of
     the same tile edges (library_ms, a yardstick the port never calls).
  5. GAT kernel phase: on the GAT plan (threshold 32; pack 1 and 16) at
     f = 128, 64, 32, B2 against gat_bcsr_plain with att at scale 0.1
     (unshifted and with the exact row shift) and 15 (shifted), and B5
     against bcsr_rowmax_plain; plus a ragged raw-count plan with a
     filler-only run.  Check: num max|d| <= 1e-5 * max|plain|, den the same
     and the gate, B5 exactly equal (-inf rows included).
  6. GAT slice phase: bench.py --model gat's path — the same graph, int8
     [512, 256] tiles at threshold 32, 4-slot residual, the 3-layer
     512 -> 128 -> 64 -> 32 GAT forward (fast=True, dot_mode='split2',
     un-stabilized) with glorot_gat_weights (seed 0) through convert.py.
     Five forwards; B2 must launch 3 times per forward and B5 never.  Each
     layer, from its own float32 input, passes the gate against a float64
     edge-list oracle with 0 bad elements; the whole chain is bounded as the
     GCN's.  Then one stabilize=True forward (its own path: B5 must launch 3
     times) and one stabilize='bound' forward; both pass the gate against
     the un-stabilized output.
  7. GAT timing: forward, stabilized forward and per-layer ms; per layer B2
     and B5 ms per launch, bound, plain ms and a library yardstick (B2:
     torch.sparse.mm of the tile cells' score CSR, built outside the timed
     call, against [h | 1]; B5: index_select + scatter_reduce 'amax' over
     the cell list).
  8. training kernel phase (quick scale): on bench.py --train's plan — the
     same graph, int8 [256, 256] tiles at threshold 24, 4-slot residual,
     pack 1 and 16, with its transposed plan — at f = 128, 64, 32: B3
     (gat_bwd_dad) against gat_bwd_dad_plain and B4 (gat_bwd_dh_das)
     against gat_bwd_dh_das_plain with att at scale 0.1 unshifted and at
     scale 15 with the 'bound' shift; B1 over the transposed plan and B2 at
     [256, 256] against their plain versions; a ragged raw-count plan with a
     filler-only run, and its transpose.  Check: max|d| <= 1e-5 * max|ref|.
  9. GCN training: make_train_step over the exact GCN forward
     (512 -> 128 -> 64 -> 32, glorot_weights through convert.py, bench.py's
     features and labels, torch.optim.Adam(1e-3)).  At the initial weights,
     per layer from its own float32 input and a cos(arange) cotangent, the
     aggregation's input gradient passes the gate against float64 autograd
     through an index_add_ edge-list oracle (at most PURE_BAD_FRACTION bad),
     and each weight gradient of the whole step is within GRAD_REL_L2
     (relative L2) of the float64 edge-list chain's.  Five steps: B1 must
     launch 6 times per step (3 forward, 3 backward), no GAT kernel; the
     loss stays finite.
 10. GAT training: the same with gat_forward(fast=False, stabilize='bound',
     dot_mode='split2') and glorot_gat_weights; the per-layer check is on
     (dh, datt) against float64 autograd of the edge-list GAT oracle; for
     edges within KINK of leaky-relu's kink (where float32 and float64 may
     take different sides) the oracles take the port's side.  Five
     steps: B2, B3 and B4 must launch 3 times per step each, B5 never.
 11. training timing: train-step, forward and backward + Adam ms, per layer
     forward and backward ms; B3 and B4 ms per launch at each f against
     their bound, plain ms and a library yardstick (B3:
     torch.sparse.sampled_addmm of gbar h^T on the cells' CSR, then the
     weighted row sum; B4: torch.sparse.mm of the transposed score CSR
     against gbar plus the same sampled product on the transposed pattern;
     the CSRs are built outside the timed call); B1 over the transposed
     plan and B2 at [256, 256], the same four numbers.
 12. SDDMM kernel phase: on bench.py --model sddmm's plan (the same graph,
     [256, 128] tiles at threshold 24 split into a 1-bit and an int8 part,
     4-slot residual), at pack 1 and 16 and f = 128, 64, 32, B6 against
     sddmm_bcsr_plain on N(0, 1) a and b, float32 and bfloat16 cells; plus a
     ragged raw-count plan with a filler-only run (whole and split), a
     1-bit plan with R = 200, and a non-edge whose dot is inf.  Check:
     float32 max|d| <= 1e-5 * max|plain|, bfloat16 at most one ulp apart,
     cells without an edge exactly +0.
 13. SDDMM slice phase: bench.py's path — hybrid_sddmm at f = 32 with
     a = normal_features(seed 3) * 0.1, b = (seed 4) * 0.1, split23 dots,
     a f16_split2 residual, bfloat16 cells.  Five calls; B6 must launch once
     per part per call.  Every edge maps through its part's (row-tile,
     col-tile) -> tile index to a cell whose value passes the gate against
     the float64 dot; every cell without an edge is +0; every residual edge
     passes the gate; dense + residual edges = m (checked in chunks).
 14. 1-bit GCN phase: phase 3's plan split by split_bit_tiles; B1 over the
     1-bit part against its plain version (pack 1 and 16, a ragged factored
     plan's 1-bit part), then five forwards: B1 must launch 6 times per
     forward (3 layers x 2 parts); phase 3's per-layer gates, and the output
     passes the gate against phase 3's int8 forward.
 15. timing: the SDDMM path's ms and edges/s (bench.py's metric m / t), B6
     ms per launch per part (pack 1 and 16) against its bound, its plain
     version and torch.sparse.sampled_addmm of b a^T on the nonzero cells'
     CSR (built outside the timed call), the residual's ms; the 1-bit GCN
     forward, and per layer B1 over the 1-bit part against its bound, plain
     version and torch.sparse.mm, beside B1 over the int8 part and over the
     unsplit plan.
 16. 1-bit kernel phase (bit-tile training's kernels): on bench.py --train's
     default plan (phase 8's split by split_bit_tiles, with each part's
     transpose), pack 1 and 16, f = 128, 64, 32: B2 and B3 over the 1-bit
     part, B4 and B1 over its transpose, B5 with B2 (gat_kernel_vs_plain);
     B2 and B5 over the 1-bit part of phase 6's plan; the ragged raw-count
     plan's 1-bit part (filler-only runs) and its transpose; a 1-bit part
     at R = 200 (transposed [128, 200]); a non-edge whose unstabilized score is
     inf.  Check: max|d| <= 1e-5 * max|plain|, B5 exactly equal.
 17. GCN bit-tile training: phase 9 on the bit-tile plan.  Five steps: B1
     must launch 12 times per step (3 layers x 2 parts, forward and
     backward), 6 of them 1-bit; the first step's weight gradients within
     BITS_REL_L2 (relative L2) of phase 9's.
 18. GAT bit-tile training: phase 10 on the bit-tile plan (the kink sides
     looked up in both parts).  B2, B3 and B4 must launch 6 times per step
     each, 3 of them 1-bit, B5 never; first-step gradients as in 17.
 19. 1-bit GAT forward: phase 6's plan split by split_bit_tiles.  Five
     forwards: B2 6 launches a forward (3 1-bit), no other kernel; one
     stabilize=True forward: B5 6 launches (3 1-bit).  Both outputs pass
     the gate against phase 6's int8 outputs with 0 bad elements.
 20. timing: the bit-tile GCN and GAT steps (step, forward, backward +
     Adam) beside phase 11's; per part (1-bit and int8) phase 11's kernel
     rows (B3, B4, B1 transposed, B2); B5 over each part of the GAT plan as
     phase 7 times it; the 1-bit GAT forward with and without stabilize.
 22. float-tile kernel phase (quick scale): B1 over float32 tiles (the
     weighted GCN plan: [512, 256] t48 of gcn_norm_val, the JAX package's
     default schedule) and over bfloat16 tiles, at pack 1 and 16, f = 128,
     64, 32, on the plan and its transpose; a densify_gcn_norm plan (float32
     counts plus scales); a ragged float plan with filler-only runs; B1's
     w_epilogue over int8, 1-bit, float32, bfloat16 and factored parts at
     (f, f_out) = (32, 32), (128, 64), (64, 32).  Check: agg and trans each
     max|d| <= 1e-5 * max|plain|.
 23. path 1's forward: the 3-layer GCN with fast_layer_opts over the
     weighted float32 schedule; five forwards, B1 3 launches a forward, all
     float; phase 3's per-layer gates against a float64 edge-list oracle
     weighted by gcn_norm_val.
 24. path 1's training: five Adam(1e-3) steps (exact modes), B1 6 float
     launches a step, phase 9's gradient gates on the weighted oracle.
 25. path 2, bench.py --tile-dtype bf16: phase 3's forward over bfloat16
     count tiles; B1 3 float launches a forward; at most PURE_BAD_FRACTION
     of the output misses the gate against phase 3's int8 forward (int8
     cells cap at 127 and spill the rest to the residual; bfloat16 cells
     keep every edge and round an odd count above 256, as the JAX
     package's bfloat16 tiles do).
 26. path 3, the updateval chain: hybrid_sddmm over bench.py --model
     sddmm's plan (float32 cells), tileplan_with_values per part, B1 over
     the float32 tiles (B6 and B1 once a part); the result passes the gate
     against float64 (S * A_dense) @ h.
 27. path 4, the fused aggregate+GEMM: hybrid_spmm_nn over fig10b_pallas's
     schedule (int8 [256, 128] t24, residual 4, f = 32, W = 0.1 *
     normal_features(32, 32, seed 3)); five calls, the w_epilogue kernel
     once a part a call; agg and trans pass the gate against float64 (agg,
     agg @ W).  Then the timing of paths 1-4 and the B1 rows of PERF.md
     (float32, bfloat16, transposed, the chain's tiles, the epilogue beside
     B1 + matmul), with the fused call against the split one.
 28. repairs: C1, one source's as at 95 and 120 on a 16x16 case and at 120
     on the GAT plan (int8 [512, 256] t32, transposed plans): forward and
     gradients of stabilize=True and 'bound' finite and within the gate
     (absolute floor 1e-5 * max|ref|) of float64 autograd of the softmax;
     B2, B3 and B4 against their plain versions there.  C2, a row whose
     neighbors lie 200 logits below the global bound, the same gate.  C4,
     the f16_split2 gathers (weighted_task_sums, sddmm_slots,
     _att_slots_flat) with rows past 65504 under
     torch.cuda.set_sync_debug_mode("error"), within the gate of float64.
 29. float-tile GAT and SDDMM kernel phase (quick scale): B2, B5, B3 and B4
     over float32 and bfloat16 tiles against their plain versions at
     f = 128, 64, 32, att at scale 0.1 unshifted and at scale 15 with the
     exact and the 'bound' shift, on the plans of phases 30-33 (pack 1 and
     8; the training plans pack 1 and 16), the gcn_norm_val plan, a ragged
     float plan with filler-only runs and a signed-value plan (U(-1, 3):
     every nonzero cell is scored, C6), with their transposes; B6 over the
     same plans at f = 32 and 128 (cells whose value is not > 0 exactly
     +0); a zero cell whose unstabilized score is inf; one source's as at
     95 and 120 on G1's plan (B2-B4 against plain, forward and gradients
     against the float64 softmax).  Check: max|d| <= 1e-5 * max|plain|,
     B5 exactly equal, B6's bf16 cells within one ulp.
 30. G1, the GAT forward over the JAX package's default schedule
     (schedule_hybrid(g, pack=1): float32 count tiles [256, 128], the
     default threshold, residual block 8, transposed plans), fast=True,
     split2: five forwards, B2 3 float launches a forward; phase 6's
     per-layer gates (0 bad); stabilize=True (B5 3 float launches) and
     'bound' against the un-stabilized output.
 31. G2, bench.py --model gat --tile-dtype bf16: bfloat16 count tiles on
     phase 6's plan; as phase 30, but each layer held to PURE_BAD_FRACTION
     against the float64 oracle (bfloat16 rounds an odd count above 256 in
     a hub cell, as the JAX package's bfloat16 tiles do; phase 25).
 32. T, GAT training over float tiles: phase 10 (gradient gates, five Adam
     steps, stabilize='bound') on bench.py --train's [256, 256] t24 plan as
     bfloat16 tiles (bench.py --train --model gat --tile-dtype bf16) and as
     float32 tiles (the JAX default dtype), each with its transpose; B2, B3
     and B4 3 float launches a step each.
 33. S, hybrid_sddmm over float32 plans (G1's and the gcn_norm_val [512,
     256] t48 plan, whose values are not integers), f = 32, five calls, B6
     one float launch a call: every cell whose value is > 0 and every
     residual slot against the float64 dot.  Then the timing of phases
     30-33: G1 and G2 forward and per-layer ms with B2 and B5 rows, the T
     steps with B3, B4, B1 transposed and B2 rows, the S passes' ms and
     edges/s with B6 rows (and B6 over G2's bfloat16 plan).
 34. B2's other modes (quick scale): on the GAT plan of phase 6, its 1-bit
     part and G1's float32 plan, f = 128, 64, 32, att at scale 0.3
     unshifted and with the exact and the 'bound' shift: B2 'default'
     against gat_bcsr_plain(dot_mode='default') (num within 1e-5 *
     max|plain| plus one bf16 ulp of each rounded score times |h|, den
     within 1e-5 and the gate, and nearer to it than to the exact plain
     version by DEFAULT_ROUNDING_RATIO in L2) and the factored kernel ('twodot' and
     'merged', hv_chunks 2 and 1) against _factored_sums over the same
     per-node operands (1e-5 * max|plain|), no row rescued.  Wide logits:
     the hub's as at 95 and 120 on the GAT plan, stabilize=True and
     'bound' (with hybrid_gat's C2 rescue): every factored mode through
     gat_bcsr_tiles finite and within WIDE_TOL of the float64 softmax over
     the tile cells (twodot with two chunks within the gate), against the
     same on the plain versions, the rescued rows printed.  Figure 10a's
     ablation path: gat_bcsr_tiles in each factored mode over the GAT
     plan, one call a layer (twodot and merged 6 launches each); its
     timing beside B2 maxdot and 'default' on all three plans, with the
     plain versions and the library yardstick on each.
 35. --gat-dot-mode default (quick scale): five forwards of bench.py
     --model gat's path with dot_mode='default' (B2 3 'default' launches a
     forward, no other kernel), its share of elements outside the gate
     against the split2 forward (and per layer from the split2 forward's
     inputs); five GAT training steps (stabilize='bound', bench.py --train
     --model gat --gat-dot-mode default's int8 plan): finite losses, B2
     ('default'), B3 and B4 3 launches a step, per-layer (dh, datt)
     against float64 autograd and first-step gradients of w and w_att
     within GRAD_REL_L2 of the float64 chain, each layer's oracle taking
     the port's rounded output and its backward's rule; two planted
     backward faults must miss that bound.
 36. the residual-DMA probe at --small size (quick graph, f = 128, int8
     [256, 128] t24, residual 4): the probe plan's work list printed; over
     the probe plan, its form skewed as phase 37 skews plans (also at f =
     160) and a factored plan of the same graph, P1 and P2 each called
     twice (bitwise equal), P2's
     dense_out bitwise B1's output times scale_dst and its task sums
     bitwise P1's, both against weighted_task_sums and bcsr_spmm_plain
     (1e-5 * max|plain|); the probe's --mode standalone and --mode fused
     through its own measure() (P1 and P2 launched); then P1,
     embedding_bag (the library yardstick), the plain residual, P2 (its
     walk blocks alone, its finish pass), B1, B1 then P1
     and B1 then spmm_plain timed by CUDA events and as device time.
 37. the cell walk of B1 and B2 (quick scale): every main plan's work list
     printed (chunks, runs cut, the largest chunk in cells, the scratch
     bytes at f = 128; the GCN and GAT plans' also at the start of phases
     2 and 5, at either scale); on the GCN and GAT int8 plans, the training
     plan's transposed 1-bit part and G1's float32 plan, B1, its
     w_epilogue and B2 in every mode called twice (bitwise equal) and held
     to their plain versions; then the same on the GCN plan and G1's plan
     skewed: every tile in one run, one all-ones tile row; and B1's time
     over the GCN plan at f = 128 with the chunk bound at 2^14 cells, the
     default and 2^20 (no run cut).
 38. B3 and B5 on the cell walk (quick scale): the work list of every plan
     B5 runs on (the GAT plan and its 1-bit and int8 parts, G1, G2 over
     bfloat16) and of every plan B3 runs on (the training plan and its
     parts, T over float32 and bfloat16), printed; each kernel called twice
     (bitwise equal) and held to its plain version (B5 equal, B3 within
     KERNEL_TOL * max|plain| at f = 128, 64, 32, att at scale 0.1 and at
     15 with the 'bound' shift); the same on phase 37's skewed plans (B3
     also at f = 160, the walk's f-slices); then B5 timed on each of its
     plans and B3 on each of its at f = 128, by CUDA events and as device
     time alone (torch.profiler's kernel time, per kernel and summed).
 39. B4 on the cell walk and B6 streamed (quick scale): the work list of
     every plan B4 runs on (the training plan's transpose, its 1-bit and
     int8 parts' transposes, T's float32 and bfloat16 transposes) and B6's
     blocks over its plans (the SDDMM path's 1-bit and int8 parts, G1,
     gcn_norm_val, G2), printed; B4 twice (bitwise equal) against its plain
     version (dh and d_as within KERNEL_TOL * max|plain| at f = 128, 64,
     32, 160, att at scale 0.1 and at 15 with the 'bound' shift), B6 twice
     (bitwise equal) against its plain version at f = 32 and 128 in
     float32 and bfloat16 cells (phase 29's tolerances); the same on phase
     37's skewed plans; then B4 at f = 128, 64, 32 and B6 at f = 32 on each
     plan by CUDA events and as device time per kernel (the walk, its finish
     and the row dot apart); the updateval chain (phase 26's path) building
     no list on its second call, timed with the weighted plans walking the
     count plans' lists and with a list built at every call (the earlier
     path), with a torch.profiler table of each.
 40. gather plans (quick scale): Aggregator.schedule over the graph with
     neighbor grouping at B = 32 (bench.py --strategy gather's plan, with
     its transposed plan), locality + neighbor grouping over 8 source
     partitions at B = 32 (the JAX CLI's default), and nop over a graph of
     16 in-neighbours a node (sources from numpy seed 16); each plan's
     build seconds and stats().
 41. bench.py --strategy gather at full width, no kernel of the port on
     it (every launch count stays 0): five 3-layer GCN forwards (ReLU after
     every layer, glorot_weights seed 0) over each of the two graph plans,
     each layer and the chain held to phase 3's gates (the gather sums in
     float32 exactly, so the modes' oracle is the float32 transform's);
     one SpMM pass at f = 128 (bench.py --model spmm's h) over NG, locality
     + NG and the nop plan, spmm_nn at f = 32, all against float64
     edge-list oracles (the gate, 0 bad); five SDDMM passes at f = 32 with
     f16_split2 rows (bench.py's fast mode), every edge against its
     float64 dot, over NG and over locality + NG (edge order through
     edge_perm); five GAT forwards (glorot_gat_weights seed 0) over the NG
     plan un-stabilized and five with stabilize=True, each layer against
     gat_edge_oracle (0 bad) and the chain; gat_split_forward's base and
     adapter pipelines against gat_aggregate on layer 1's inputs.
 42. GCN training over the NG plan and its transposed plan (spmm_bidir):
     phase 9's gates (per-layer input gradients against float64 autograd,
     the first step's weight gradients within GRAD_REL_L2 of the float64
     chain) and five Adam steps with a finite loss; no kernel launches.
 43. gather timing (CUDA events, median of 10 after 3 warm-ups, and the
     profiler's device time): the GCN forwards and their layers; the SpMM
     at f = 128, 64, 32 over both plans beside torch.sparse.mm over the
     same CSR (a yardstick the port never calls) and the bytes bound
     (slots x f x 4 read, n x f x 4 written, at HBM_BYTES_PER_S); the SpMM
     pass's edges/s and peak memory; the SDDMM pass; the GAT forwards; the
     training step; and P1 (task_sums_cuda, another yardstick) beside
     weighted_task_sums over the NG plan's task sums at f = 128, their
     results compared.  A "gather" JSON line carries them.
 44. SAGE-LSTM at full width, bench.py --model sage's inputs (no kernel of
     the port on it; every launch count stays 0): presample_fixed_neighbors
     (k = 16, seed 2) over the quick graph, x = normal_features(n, 32,
     seed 3) * 0.1, the LSTM's and the layer's weights from a seeded
     generator (f = 32); lstm_aggregate's redundancy_bypass (float32 gates,
     and float16 gates, bench.py's fast default), sparse_fetch and
     materialize, and sage_lstm_layer (f_out = 32), each float32 run against
     a float64 recurrence on the card (the gate, 0 bad); the float16 run 0
     bad against the float64 oracle of its own rounding and at most
     F16_GATE_BAD_FRACTION off the gate against the unrounded one (its
     share printed); torch.nn.LSTM (cuDNN, a yardstick the port never calls) over
     the materialized [n, 16, 32] sequence, slabs permuted into its layout,
     within the gate of the port and of the float64 oracle.
 45. the edge MLP at f = 32, bench.py --model edgemlp's inputs (h =
     normal_features(n, 32, seed 3) * 0.1, W seed 4): edge_mlp and
     edge_mlp_chunked over phase 40's NG, locality + NG and nop plans, each
     against a float64 edge-list oracle (index_add_; the gate, 0 bad); no
     kernel launches.
 46. timing (CUDA events, median of 10 after 3 warm-ups, and the profiler's
     device time by kernel): each LSTM run, the layer and cuDNN's LSTM
     (edges/s = n * 16 / t, as bench.py counts them; peak memory); the edge
     MLP over each plan (edges/s = m / t, peak memory) beside the slot
     bound ((slots + n) x 32 x 4 bytes).  A "sage" and an "edgemlp" JSON
     line carry them.
 47. (--scale reddit only) the SAGE aggregate (float16 gates) over the
     uncut graph, its gates as phase 44's, beside the V100 anchor (14.204
     ms); edge_mlp_chunked over the reddit NG plan of phase 41, held to the
     float64 edge-list oracle taken in chunks; times and peak memory.
 48. the reorders (quick scale): bench.py --graph community (community_graph
     65,536 v / 4,194,304 e, seed 123, with its default --reorder hublpa:
     label_propagation_reorder with the max(256, n / 128) highest-degree
     vertices first) and phase 1's RMAT graph under --reorder degree, lpa,
     cluster and cluster_exact; each permutation a bijection, its host
     seconds printed.  Over each graph, bench.py's GCN plan at
     --quick (int8 [512, 256] t48, residual 4) and five GCN forwards with
     fast_layer_opts: B1 3 launches a forward, no other kernel; per layer
     the modes' float64 oracle 0 bad and, against the unrounded one, at
     most PURE_BAD_FRACTION of misses beyond those of the modes' own
     float64 result ('split' tiles round z to 16 bits: at cancellation
     points on the community graph that alone misses 39 of 4,194,304 in
     layer 2, 9.3e-6, and 38-42 as layer 1's sum order moves its input);
     the whole chain's share off the unrounded oracle printed, not gated
     (1.9e-5 on the community graph).  Over the community
     graph also the GAT plan (int8 [512, 256] t32) and five stabilize=True
     GAT forwards (B2 and B5 3 launches a forward each) with phase 6's
     gates.  Per graph: tiles, the share of edges in tiles, residual slots,
     the forward's ms by CUDA events and device time.
 49. the CLI on the card, in this process (utils.cli.main, so the launch
     counts can be read), over --syn rmat:65536:1048576 (the JAX README's
     quick-start graph): info, schedule, bench --model gcn|gat|sage_lstm
     (gather plans and the LSTM: no kernel), tune --iters 2 (its table
     lists the 4 gather and the 6 bfloat16 hybrid candidates in the JAX
     order, the graph being weighted; B1 launched over their tiles alone)
     and train --epochs 5 (no kernel; the loss finite and falling); every
     last stdout line parses as JSON.
 50. profiling.decompose (quick scale) over phase 3's plan (gcn) and phase
     6's (gat), rebuilt alike, at f = 128, 64, 32: every phase present,
     finite and positive; dense launching B1 (B2) alone; dense within
     DECOMPOSE_TOL (30%) of the kernel's per-launch time phase 4 (7) took
     on the same plan at the same f; analytic equal to plan_cost and
     tile_cost.
 51. (quick scale, as 52-54) the all-gather hybrid GCN (parallel.allgather_tiles)
     at full width over phase 1's graph: build_allgather_hybrid at D = 4,
     int8 [512, 256] t48, residual 4, 1-bit and int8 groups split local /
     halo, pack 8, with the groups' transposes; the 4 rank bodies run on
     the card in turn, each given its rows and the whole buffer (what the
     all-gather gives it).  B1 launches once a group, rank and layer (and
     its 1-bit launches once a 1-bit group's); each layer from its own
     float32 input passes the gate against the float64 edge oracle with 0
     bad elements; the forward within PAR_TOL (1e-5) * max|ref| of the
     single-card schedule_hybrid forward; B1 over every group and every
     transposed group against bcsr_spmm_plain (KERNEL_TOL) at f = 128, 64,
     32; per (f, rank) B1's ms over the body's launches, their bound, the
     plain version's ms and torch.sparse.mm over the same cells; each rank
     body's ms and the whole forward's.
 52. the dry run's training step (multichip.train_step: the all-gather
     hybrid, ring hybrid and gather ring in one loss) in an NCCL world of
     one on the card, over the toy graph of D = 4: the loss finite, B1
     launched once a group and layer forward and backward (over the
     transposes), the loss within 1e-5 relative and the weight gradients
     within GRAD_REL_L2 of the same step in a gloo group on the CPU; the
     D = 4 rank bodies' three forwards within PAR_TOL of the world of
     one's on the graph's rows; the step's ms (the plan parts put on the
     card once before it; the toy features and labels are copied in it).
 53. the dry run's all-gather forward at arxiv scale (RMAT 169,343 v /
     1,166,243 e, seed 11, [256, 128] t16, residual 4, pack 8, f = 32)
     with the step's weights as D = 8 rank bodies: B1 once a group, body
     and layer, finite, each layer against the float64 edge oracle (0
     bad), B1 over every group against its plain version, its times.
 54. RMAT 32,768 v / 1,048,576 e (seed 123, degree sorted) through the
     gather ring (NG B = 32), the ring-hybrid GCN and GAT (f = 64; float32
     [256, 128] tiles; plain torch, no kernel launched) and the
     feature-parallel GCN (phase 3's plan; B1 once a rank and layer), as
     D = 4 rank bodies, each within PAR_TOL * max|ref| of the single-card
     port (gather forward, schedule_hybrid forward, gat_aggregate, the
     aggregate-first forward); their ms, with every rank's plan parts put
     on the card once before (mesh.shard_all), as in phases 51 and 53.
 55. the figure harness (gnn_computing_tpu_torch/benchmarks): every
     figure's main() at --quick (rmat_quick), --iters 4, into a temporary
     results directory, through its check hook (FigureCheck): one call of
     each timed function must launch launches_of's kernels (B1 3 a fig7 GCN
     forward; B2 3 a fig7 fast GAT forward, one a layer over its one int8
     tile part, no B5; B1 once a call of fig9's hybrid_spmm, of fig8's
     hybrid pass and of fig10b_pallas's split and fused calls, the fused
     one through the w_epilogue; nothing on fig8's, fig9's and fig10's
     gather rows or fig11), and the counts of each figure's run (set to 0
     just before, read just after) must equal those calls' launches summed
     over the calls timed (fig8's decompose phases added), each figure's
     kernels launched; every row parses, names the card and its power limit
     and holds finite times > 0.
 56. one real dataset a figure (SYN_DATASETS): rmat_mid (65,536 v /
     8,388,608 e) for fig7, fig8, fig10 and fig11, comm_mid for fig7's
     label-propagation route, rmat_arxiv for fig9 (FIG9_DATASET), each
     graph's host build seconds and fig9's reorders' printed; --iters 8; as
     phase 55, and before it is timed one output of every timed function
     against its float64 oracle (figure_oracle: the GCN layers against
     their modes' oracle as phase 3, the GAT layers against the softmax
     oracle as phase 6, the LSTM against its float64 recurrence as phase
     44, A @ h, (A @ h) @ W and 10a's attention aggregation against float64
     edge-list sums with 0 elements off the gate).
 57. scaling.py at d = 1 on the card (an NCCL world of one), the ring
     hybrid and --allgather at their defaults (n = 65,536, m = 4,194,304,
     f = 32), --iters 8: the rank's output within PAR_TOL * max|ref| of the
     single-card schedule_hybrid forward of the same graph, B1 launched on
     every call of the all-gather rank and never in the ring's; one
     representative row a path.
 58. the port's entry points: gnn_computing_tpu_torch.entry.entry() on
     the card (RMAT 4,096 v / 65,536 e, int8 [512, 128] t24 split into a
     1-bit and an int8 part, pack 8), ENTRY_FORWARDS forwards with B1 6
     times a forward (3 of them 1-bit) and no other kernel, each layer
     against the float64 oracle of its modes and the chain as phase 3, its
     time; then python -m gnn_computing_tpu_torch.bench --quick --iters 4
     as subprocesses, all five at once (each a host-only build child, then
     a fresh timed child, into a temporary cache of its own) for gcn, gat,
     sddmm, gcn --train and gat --train: each exits 0, its first stdout
     line is bench.py's metric with a finite value > 0, and its capture
     row's launches (counted by the timed child around its timed run) are
     the timed calls times one call's (B1 3 a part a forward, 6 a training step over the parts and
     their transposes; B2 3 a part; B3 3 a part and B4 3 a transposed part
     a GAT step; B6 one a part an SDDMM call), no other kernel.  Between
     the two, B1 over bench.py --scale products's geometry (int8 [1024,
     128] t384 split into 1-bit and int8 parts, pack 1 and 4) on phase 1's
     graph against its plain version at f = 128, 64, 32, as phase 2.
 59. the hybrid op's residual kernel R1 (csrc/residual_spmm.cu, through
     ops.spmm.residual_spmm_) at the benchmark cells' residual plans: the
     RMAT graphs of ogbn-products' and reddit's sizes (structure seed 123,
     degree sorted), densified as the cells (int8 [1024, 128] t384; [256,
     256] t24), 4-slot neighbor grouping, and reddit's transposed residual
     (the training step's backward), at f = 128, 64, 32: one launch a
     call, against the float64 result within the worst-case bound of a
     float32 sum of each row's terms in any order (the plain version held
     to the same, its distance printed beside), its ms
     (CUDA events) and device ms (profiler), its bytes bound (each edge's
     source row, the plan's 12 bytes a slot and a task, out read and
     written) and the distinct-rows bound, the plain version's ms and
     torch.sparse.mm of the residual CSR (library_ms); a "residual" JSON
     line and a kernels entry "residual_spmm".
 60. the published multi-head GAT (models.gat.gat_heads_forward through the
     benchmark's model module, its gat-ppi configuration and Glorot draw: 512
     -> 4 x 256 concat -> 4 x 256 concat with an identity skip -> 6 x 121
     mean, ELU) on the training cells' plan at the quick scale (int8 [256,
     256] t24 split into 1-bit and int8 parts, pack 16, residual 4,
     transposes): B2, B3 and B4 against their plain versions at f = 256 (two
     f-slices) and f = 121 (the scalar path) over each part, as phases 5 and
     8; one head's aggregation (hybrid_gat, stabilize 'bound', 'exact') at
     each width, its output against the float64 edge-list oracle under the
     gate and its (dh, datt) against float64 autograd (phase 10's kink rule),
     with B2 once a part, B3 once a part and B4 once a transposed part; then
     the model: one training step recorded (14 gnn.gat.head spans, counters
     gat.heads 14 and gat.head_copy_bytes), the first step's loss within 1e-6
     and each projection's and attention vector's gradient within
     HEADS_W_REL_L2 and HEADS_A_REL_L2 (relative L2) of the benchmark's
     float64 reference (portbench/reference/gat_heads.py), TRAIN_STEPS steps
     with B2, B3 and B4 once a head a part and a finite loss, and the step's
     time; a "heads" JSON line.
 61. B1's staged walk (csrc/cell_walk.cuh: stage_kernel) at the quick
     scale, on the int8 parts of the benchmark's reddit plans (RMAT seed
     123, degree sorted; the training plan [256, 256] t24 and its
     transpose, the forward plan [512, 256] t48; split into 1-bit and int8
     parts before pad_runs(16)): at f = 128, 64, 32, 121 (the scalar path)
     and 256 (two f-slices), B1 and, at f <= 128, its w_epilogue with the
     plans' staged chunks (cell_walk.STAGE_K) staged (the launch's rule,
     cell_walk.stages, set to stage) bitwise equal to the same chunks
     walked by gathers (set not to), and the plan's own launch (the rule:
     here too few staged blocks to fill the card, so the gather walk)
     bitwise the same, one launch a call, and within KERNEL_TOL of the plain
     version; the ms of the three (CUDA events) at f = 128, 64, 32; under a
     recording, walk.staged_cells and walk.cells a staged launch as the work
     list counts them, and 0 staged cells over the 1-bit parts; a "staged"
     JSON line.
 21. (printed last) a "float_gat" JSON line, a "modes" JSON line (phases
     34-36: the ablation's times, the rescues, the 'default' off-gate
     share, losses and gradient errors, the probe's runs), the "reorder"
     and "cli" lines (phases 48-49), the "parallel" line (phases 51-54;
     B1's kernel entry carries their "allgather" rows), the "sage" and
     "edgemlp" lines (phases 44-47), the "gather" line (phases 40-43), the total
     seconds, one "kernels" JSON line (B1's, B2's, B3's, B4's, B5's and
     P2's entries with "walk": "cell", their plans' work lists and B3's,
     B4's and B5's phase 38-39 times; P1's and P2's phase 36 times; B6's
     with "design": "streamed", its phase 39 times and the chain's; B1's
     and B2's "figures" launches of phases 55-57), a "figures" JSON line
     (phases 55-57: each figure's rows, the launches of each run, the
     graphs' build seconds, the phases' seconds), the card line, then
     {"ok": true, ...}.  Phase 58's "bench" JSON line comes before the
     "sage" line; B1's kernel entry carries its "entry" launches, and B1's,
     B2's, B3's, B4's and B6's a "bench" entry (launches by run).

With --scale reddit, phases 8-11, 16-20 and 22-39 are replaced by one GCN
bit-tile training phase at reddit scale (bench.py --train's headline
configuration): the [256, 256] t24 bit-tile plan with its transposes and
its build time, the first step's weight gradients within BITS_REL_L2 of
the same step over the same parts passed through unpack_bits() (a check
on the card, not the training path), REDDIT_STEPS steps with B1 at 12
launches a step (6 1-bit) and a finite loss, and the step's time; and
phases 40-43 by the gather GCN forward over the reddit graph's NG plan (B
= 32, spmm_plain in chunks of CHUNK_SLOTS slots), phase 3's gates, its time
and peak memory; phases 44-46 by phase 47; phases 48-61 run at the quick
scale only.

Launch counts: every count is set to 0 just before a path is driven and
read just after it (the GCN forward for B1, the GAT forward for B2, the
stabilized GAT forward for B5, five GCN training steps for B1, five GAT
training steps for B2, B3 and B4, five SDDMM calls for B6, five 1-bit GCN
forwards for B1, the bit-tile phases' steps and forwards, phases 23-27's
forwards, steps, chain and fused calls, phases 30-33's forwards, steps
and SDDMM calls, phase 34's ablation path, phase 35's forwards and steps
and phase 36's probe runs; phases 41-42's gather paths and phases 44-45's
and 47's SAGE-LSTM and edge-MLP runs, which must leave every count at 0;
phase 48's forwards, each of phase 49's subcommands and each of phase
50's decompose calls, each figure run of phases 55-56, phase 58's entry
forwards, and each bench run's timed calls, counted by the bench's timed
child itself); launches made to compare a kernel with its
plain version are not counted.  Each wrapper also counts its 1-bit launches apart
(``bits_launches``) and its float-tile launches (``float_launches``; B3/B4
``dad_float_launches`` / ``dh_das_float_launches``); B1 its w_epilogue
launches (``epilogue_launches``), B2 its 'default' ones
(``default_launches``); the factored kernel counts ``twodot_launches`` and
``merged_launches``, the probe's kernels ``task_sums_launches`` and
``fused_launches``.  R1, the hybrid op's residual (``cuda_residual.launches``),
launches once a hybrid GCN aggregation whose residual rows are float32 and
whose residual plan has a task (``residual_layers``: once a forward under
fast_layer_opts, 3 in the exact modes, 6 a training step) and once a GAT
training step's layer (the residual's dh over the transposed plan); the
paths that run it are held to those counts beside their tile kernels.  The
training phases run at the quick scale only (their float64 oracles hold
the whole edge list in memory).

The port schedules with pack=1: the CUDA kernels take runs of any length,
so the TPU kernel's filler tiles would only add work (their cost is printed).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from gnn_computing_tpu_torch import entry as port_entry
from gnn_computing_tpu_torch import multichip
from gnn_computing_tpu_torch.aggregator import Aggregator
from gnn_computing_tpu_torch.benchmarks import common as fig_common
from gnn_computing_tpu_torch.benchmarks import fig7_models, fig8_balance, fig9_locality, fig10_fusion, fig11_sage
from gnn_computing_tpu_torch.benchmarks import scaling as fig_scaling
from gnn_computing_tpu_torch.convert import gat_params_from_jax, gcn_params_from_jax
from gnn_computing_tpu_torch.graph import (
    CSRGraph,
    cluster_reorder,
    cluster_reorder_exact,
    community_graph,
    degree_sort,
    label_propagation_reorder,
    normal_features,
    rmat_graph,
)
from gnn_computing_tpu_torch.graph.sample import presample_fixed_neighbors
from gnn_computing_tpu_torch.models.gat import gat_forward, glorot_gat_weights
from gnn_computing_tpu_torch.models.gcn import (
    BENCH_DIMS,
    LayerOpts,
    fast_layer_opts,
    gcn_forward,
    gcn_layer,
    glorot_weights,
)
from gnn_computing_tpu_torch.models.sage_lstm import init_sage_lstm_params, sage_lstm_layer
from gnn_computing_tpu_torch.models.training import make_train_step, softmax_xent
from gnn_computing_tpu_torch.ops import (
    bcsr_gat,
    cell_walk,
    cuda_bcsr,
    cuda_build,
    cuda_gat,
    cuda_gat_bwd,
    cuda_residual,
    cuda_rowmax,
    cuda_sddmm,
)
from gnn_computing_tpu_torch.ops.bcsr import (
    _post_scale,
    _pre_scale,
    bcsr_rowmax,
    bcsr_rowmax_plain,
    bcsr_spmm,
    bcsr_spmm_plain,
    round_h,
)
from gnn_computing_tpu_torch.ops.bcsr_gat import (
    _bound_rescue,
    _factored_sums,
    _global_bound_shift,
    _hybrid_row_shift,
    _resolve_shift,
    _score_terms,
    factored_terms,
    gat_bcsr,
    gat_bcsr_factored,
    gat_bcsr_merged_plain,
    gat_bcsr_plain,
    gat_bcsr_tiles,
    gat_bcsr_twodot_plain,
    gat_bwd_dad,
    gat_bwd_dad_plain,
    gat_bwd_dh_das,
    gat_bwd_dh_das_plain,
)
from gnn_computing_tpu_torch.ops.bcsr_sddmm import hybrid_sddmm, sddmm_bcsr, sddmm_bcsr_plain, tileplan_with_values
from gnn_computing_tpu_torch.ops.edge_mlp import edge_mlp, edge_mlp_chunked
from gnn_computing_tpu_torch.ops.fused_nn import bcsr_spmm_nn, bcsr_spmm_nn_plain, hybrid_spmm_nn, spmm_nn
from gnn_computing_tpu_torch.ops.gat import DEFAULT_SLOPE, _att_slots_flat, gat_aggregate, gat_split_forward
from gnn_computing_tpu_torch.ops.lstm import init_lstm_params, lstm_aggregate
from gnn_computing_tpu_torch.ops.spmm import (
    edge_values_from_slots_flat,
    kernel_takes,
    residual_spmm_,
    sddmm_slots,
    spmm,
    spmm_plain,
    weighted_task_sums,
)
from gnn_computing_tpu_torch.parallel import build_ring_plan, make_mesh
from gnn_computing_tpu_torch.parallel.allgather_tiles import (
    _local_allgather_hybrid,
    allgather_hybrid_gcn_forward_bodies,
    allgather_hybrid_spmm_bodies,
    build_allgather_hybrid,
)
from gnn_computing_tpu_torch.parallel.feature_parallel import feature_sharded_gcn_forward_bodies
from gnn_computing_tpu_torch.parallel.mesh import shard_all
from gnn_computing_tpu_torch.parallel.ring import ring_gcn_forward_bodies
from gnn_computing_tpu_torch.parallel.ring_tiles import (
    build_ring_hybrid,
    ring_hybrid_gat_bodies,
    ring_hybrid_gcn_forward_bodies,
)
from gnn_computing_tpu_torch.probes import overlap_dma_residual as probe
from gnn_computing_tpu_torch.ops.validate import DEFAULT_ATOL, DEFAULT_RTOL, relative_error_count
from gnn_computing_tpu_torch.schedule import make_plan
from gnn_computing_tpu_torch.schedule.neighbor_grouping import neighbor_grouping_plan
from gnn_computing_tpu_torch.schedule.tiles import densify, densify_gcn_norm, split_bit_tiles
from gnn_computing_tpu_torch.utils import cli, profiling
from gnn_computing_tpu_torch.utils.profiling import decompose, launch_counts, plan_cost, tile_cost
from gnn_computing_tpu_torch.utils.timing import cuda_time_ms, device_ms

SCALES = {"quick": (1 << 16, 1 << 22), "reddit": (232_965, 114_615_891)}
SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=48)  # bench.py defaults
GAT_SCHEDULE = dict(tile_rows=512, tile_cols=256, threshold=32)  # bench.py --model gat
# bench.py --train; --bit-tiles off (phases 8-11), its default on (16-20)
TRAIN_SCHEDULE = dict(tile_rows=256, tile_cols=256, threshold=24)
# bench.py --model sddmm (strategy hybrid): [256, 128] tiles at t24, 1-bit
# tiles on, f = 32, split23 tile dots, f16_split2 residual, bf16 cells
SDDMM_SCHEDULE = dict(tile_rows=256, tile_cols=128, threshold=24)
SDDMM_F = 32
SDDMM_CALLS = 5
# fig10b_pallas (benchmarks/fig10_fusion.py): int8 [256, 128] tiles at t24,
# residual block 4, no transposed plans, f = 32, W [32, 32]
FUSED_SCHEDULE = dict(tile_rows=256, tile_cols=128, threshold=24)
FUSED_F = 32
FUSED_CALLS = 5
EPILOGUE_SHAPES = ((32, 32), (128, 64), (64, 32))  # (f, f_out) of the epilogue checks
CHECK_TILES = 16384  # tiles a kernel-vs-plain comparison or a cell check takes at once
CHECK_EDGES = 1 << 22  # edges an edge-to-cell check takes at once
RESIDUAL_BLOCK = 4
TRAIN_STEPS = 5
GRAD_REL_L2 = 1e-4  # whole-step weight gradients against the float64 chain
# a bit-tile step's weight gradients against the same step over int8 tiles
# (float32 summation order only: the parts add their partial sums)
BITS_REL_L2 = 1e-5
REDDIT_STEPS = 3  # bit-tile GCN training steps at --scale reddit
GATHER_BLOCK = 32  # bench.py --block-size: the --strategy gather plan's B
GATHER_PARTITIONS = 8  # the JAX CLI's --partitions default (locality schedules)
NOP_DEGREE = 16  # in-neighbours a node of phase 40's fixed-degree graph
GATHER_CALLS = 5
# leaky-relu's derivative jumps by (1 - slope) * the attention weight at a
# zero logit, and for an edge within ~1e-7 of it float32 and float64 may
# take different sides: for edges within KINK of it the float64 oracles
# take the side the port's float32 branch test takes
KINK = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_TOL = 1e-5  # max|kernel - plain| / max|plain|: float32 sum order only
# 'split' tiles round z to 16 mantissa bits (as the JAX package does); where a
# row's sum cancels to near zero that rounding alone misses the gate against
# the unrounded f64 oracle (the JAX package's own layer 1 at this scale: 6 of
# 8,388,608 elements).  Against the oracle of the modes the gate is exact.
PURE_BAD_FRACTION = 1e-5


def log(*a):
    print(*a, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def compare(got: torch.Tensor, want: torch.Tensor, what: str, gate: bool) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    bad = relative_error_count(got, want)
    log(f"  {what}: max|d|={err:.3e} max|ref|={scale:.3e} gate_bad={bad}{'' if gate else ' (not gated)'}")
    check(err <= KERNEL_TOL * scale and (bad == 0 or not gate), f"{what} disagrees with the plain version")
    return err


def kernel_vs_plain(tp, f: int, mode: str, gen: torch.Generator, what: str) -> float:
    """Kernel against the plain version on the same rounded operand, twice:
    nonnegative h (like post-ReLU activations) under the gate and the max
    bound; signed N(0, 1) h under the max bound only — there, sums of
    hundreds of terms up to 127*|h| cancel to near zero, where two float32
    summation orders differ by more than the gate's 1e-5 floor."""
    err = 0.0
    for signed in (False, True):
        shape = (tp.n_src, f)
        h = (torch.randn if signed else torch.rand)(shape, generator=gen, device="cuda")
        got = bcsr_spmm(tp, h, h_mode=mode)
        want = bcsr_spmm_plain(tp, round_h(h, mode))
        torch.cuda.synchronize()
        label = f"{what} f={f} {mode} {'signed' if signed else 'nonneg'}"
        err = max(err, compare(got, want, label, gate=not signed))
    return err


def tile_cells(tp):
    """(dst, src, count) of every nonzero cell of the plan's tiles."""
    cnt = tp.counts()
    t, i, j = cnt.nonzero(as_tuple=True)
    rows = tp.tile_row.long()[t] * tp.tile_rows + i
    cols = tp.tile_col.long()[t] * tp.tile_cols + j
    return rows, cols, cnt[t, i, j].double()


def tile_csr(tp) -> torch.Tensor:
    """The plan's tile edges as one [n, n_src] float32 CSR matrix."""
    rows, cols, vals = tile_cells(tp)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.float(), (tp.num_nodes, tp.n_src))
    return coo.coalesce().to_sparse_csr()


def edge_sum(z: torch.Tensor, dst, src, weight=None) -> torch.Tensor:
    """out[dst[e]] += weight[e] * z[src[e]] in z's dtype, in chunks of edges."""
    out = torch.zeros_like(z)
    step = 1 << 23
    for s in range(0, src.shape[0], step):
        msg = z.index_select(0, src[s : s + step])
        if weight is not None:
            msg *= weight[s : s + step, None]
        out.index_add_(0, dst[s : s + step], msg)
    return out


def gate_misses(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """relative_error_count's test per element, on the card: True where
    |y - ref| > rtol*|ref| + atol."""
    ref = ref.double()
    return (y.double() - ref).abs() > DEFAULT_RTOL * ref.abs() + DEFAULT_ATOL


def edge_lists(g, dev) -> tuple:
    """A graph's (dst, src) per edge as int64 tensors on ``dev``."""
    return (
        torch.from_numpy(g.dst_per_edge.astype(np.int64)).to(dev),
        torch.from_numpy(g.indices.astype(np.int64)).to(dev),
    )


def reset_counts():
    """Every kernel's launch count (and its 1-bit, float-tile and epilogue
    counts) to 0, just before a path is driven."""
    cuda_bcsr.launches = cuda_gat.launches = cuda_rowmax.launches = cuda_sddmm.launches = 0
    cuda_gat_bwd.dad_launches = cuda_gat_bwd.dh_das_launches = 0
    cuda_bcsr.bits_launches = cuda_gat.bits_launches = cuda_rowmax.bits_launches = 0
    cuda_gat_bwd.dad_bits_launches = cuda_gat_bwd.dh_das_bits_launches = 0
    cuda_bcsr.float_launches = cuda_bcsr.epilogue_launches = 0
    cuda_gat.float_launches = cuda_rowmax.float_launches = cuda_sddmm.float_launches = 0
    cuda_gat_bwd.dad_float_launches = cuda_gat_bwd.dh_das_float_launches = 0
    cuda_gat.default_launches = cuda_gat.twodot_launches = cuda_gat.merged_launches = 0
    cuda_residual.launches = cuda_residual.task_sums_launches = cuda_residual.fused_launches = 0


def counts() -> dict:
    """Every kernel's launches (B2's 'twodot' and 'merged' kernel, P1 and P2
    apart; B2's 'default' launches are among B2's)."""
    return launch_counts()


def bit_counts() -> dict:
    """The 1-bit launches among counts() (B6 has no separate count)."""
    return dict(
        B1=cuda_bcsr.bits_launches, B2=cuda_gat.bits_launches, B3=cuda_gat_bwd.dad_bits_launches,
        B4=cuda_gat_bwd.dh_das_bits_launches, B5=cuda_rowmax.bits_launches,
    )


def float_counts() -> dict:
    """The float32 / bfloat16-tile launches among counts()."""
    return dict(
        B1=cuda_bcsr.float_launches, B2=cuda_gat.float_launches, B3=cuda_gat_bwd.dad_float_launches,
        B4=cuda_gat_bwd.dh_das_float_launches, B5=cuda_rowmax.float_launches, B6=cuda_sddmm.float_launches,
    )


def only(name: str) -> bool:
    """No kernel other than ``name`` launched since the counts were reset."""
    return only_of((name,))


def only_of(names) -> bool:
    """No kernel outside ``names`` launched since the counts were reset."""
    return all(v == 0 for k, v in counts().items() if k not in names)


def residual_layers(agg, opts=None, layers: int = len(BENCH_DIMS) - 1) -> int:
    """R1's launches in one GCN forward over ``agg``: one a layer whose
    residual rows are float32 (per-layer ``opts``; None: the exact modes,
    float32 rows on every layer), none where the residual plan has no
    task (ops.spmm.residual_spmm_)."""
    if agg.plan is None or agg.plan.num_tasks_padded == 0:
        return 0
    modes = [None] * layers if opts is None else [o.residual_gather_dtype for o in opts]
    return sum(kernel_takes(torch.device("cuda"), m) for m in modes)


def only_with_r1(name: str, r1: int) -> bool:
    """No kernel but ``name`` and the hybrid op's residual kernel R1
    launched since the counts were reset, and R1 exactly ``r1`` times."""
    return cuda_residual.launches == r1 and only_of((name, "R1"))


def ragged_graph():
    """n = 5,037 (not a multiple of R) whose last row-tile is too sparse for
    any tile, so after pad_runs(16) its run is 16 filler tiles."""
    rng = np.random.default_rng(1)
    rg = rmat_graph(5000 + 37, 400_000, seed=7, with_val=False)
    rg = rg.reorder(degree_sort(rg))
    rd, rs = rg.dst_per_edge, rg.indices
    keep = (rd < 9 * SCHEDULE["tile_rows"]) | (rng.random(rg.num_edges) < 0.002)
    return CSRGraph.from_edges(rd[keep], rs[keep], rg.num_nodes), rng


def filler_only_runs(tp) -> list:
    """Row-tile runs that hold tiles, none of them with an edge."""
    lens = np.diff(tp.run_start)
    return [
        r for r in range(tp.num_row_tiles)
        if lens[r] and not tp.a[tp.run_start[r] : tp.run_start[r + 1]].any()
    ]


def gcn_edges(g, res_host, tp, val=None) -> tuple:
    """The float64 oracles' edge lists on the card: the graph's (dst, src,
    weight), the residual's, and the tile cells' (dst, src, value) of
    ``tp``; the weights are None for an unweighted graph (``val`` None),
    else the graph's edge values and the residual's own.  Checks that the
    tile cells and the residual partition the graph's edges (the
    tile/residual split comes from the host densify): per row, the counts
    add up, or for a weighted graph the values do to float32 rounding."""
    dev = tp.a.device

    g_dst, g_src = edge_lists(g, dev)
    r_dst, r_src = edge_lists(res_host, dev)
    c_dst, c_src, c_cnt = tile_cells(tp)
    n = g.num_nodes
    g_w = r_w = None
    if val is None:
        per_row = torch.bincount(c_dst, weights=c_cnt, minlength=n) + torch.bincount(r_dst, minlength=n)
        check(
            torch.equal(per_row.long().cpu(), torch.from_numpy(g.degrees.astype(np.int64))),
            "tile cells + residual edges do not partition the graph's edges",
        )
    else:
        g_w = torch.from_numpy(np.asarray(val, np.float64)).to(dev)
        r_w = torch.from_numpy(res_host.val.astype(np.float64)).to(dev)
        per_row = torch.bincount(c_dst, weights=c_cnt, minlength=n) + torch.bincount(r_dst, weights=r_w, minlength=n)
        want = torch.bincount(g_dst, weights=g_w, minlength=n)
        check(
            bool(((per_row - want).abs() <= 1e-5 * want.abs() + 1e-12).all()),
            "tile cell values + residual edge values do not add up to the graph's per row",
        )
    return g_dst, g_src, g_w, r_dst, r_src, r_w, c_dst, c_src, c_cnt


def gcn_gates(agg, weights, opts, h0, out, edges, what: str, pure: str = "count") -> list:
    """Phase 3's checks of a GCN forward over ``agg``: float64 oracles over
    edge lists (weighted where the graph is), the whole graph from the
    layer input ("pure") and the aggregation the numeric modes define
    ("mode": from the layer's own float32 transform z, tile edges take the
    tile_h_mode rounding of z times the stored tile values, residual edges
    z exactly).  Each layer, from the same float32 input, passes the gate
    against its modes' oracle with 0 bad elements.  With ``pure`` "count"
    each layer and the whole chain ``out`` miss the pure oracle on at most
    PURE_BAD_FRACTION of the elements.  With ``pure`` "beyond_modes" the
    misses that count are those where the modes' own float64 result meets
    the pure oracle (the rest are the modes' rounding at cancellation
    points, which the JAX package's modes share), at most PURE_BAD_FRACTION
    of each layer; the whole chain's share is only printed.  Returns the
    layer inputs and outputs."""
    g_dst, g_src, g_w, r_dst, r_src, r_w, c_dst, c_src, c_cnt = edges
    limit = PURE_BAD_FRACTION
    xs, chain = [h0], h0.double()
    for i, w in enumerate(weights):
        xs.append(gcn_layer(agg, xs[i], w, opts[i]))
        z32 = xs[i] @ w  # the layer's own float32 transform
        zt = round_h(z32, opts[i].tile_h_mode).double()
        mode_ref = (edge_sum(zt, c_dst, c_src, c_cnt) + edge_sum(z32.double(), r_dst, r_src, r_w)).clamp_min_(0.0)
        z = xs[i].double() @ w.double()
        pure_ref = edge_sum(z, g_dst, g_src, g_w).clamp_min_(0.0)
        bad = relative_error_count(xs[-1], mode_ref)
        port_miss = gate_misses(xs[-1], pure_ref)
        bad_pure = int(port_miss.sum())
        if pure == "beyond_modes":
            modes_miss = gate_misses(mode_ref, pure_ref)
            gated = int((port_miss & ~modes_miss).sum())
            note = f" (the modes' own f64 result misses {int(modes_miss.sum())}; beyond it {gated})"
        else:
            gated, note = bad_pure, ""
        log(
            f"  {what}layer {i + 1} (same input) vs f64 oracle: mode gate_bad={bad}, "
            f"pure gate_bad={bad_pure} of {z.numel()}{note}"
        )
        check(bad == 0, f"{what}layer {i + 1} fails the gate against its modes' f64 oracle")
        check(gated <= limit * z.numel(), f"{what}layer {i + 1}: too many elements off the pure oracle{note}")
        chain = edge_sum(chain @ w.double(), g_dst, g_src, g_w).clamp_min_(0.0)
    bad = relative_error_count(out, chain)
    chain_gate = pure == "count"
    log(f"  {what}forward vs f64 pure oracle chain: gate_bad={bad} of {chain.numel()}"
        f"{'' if chain_gate else f' ({bad / chain.numel():.3g}; not gated)'}")
    check(bad <= limit * chain.numel() or not chain_gate, f"{what}forward: too many elements off the pure oracle chain")
    return xs


def gat_kernel_vs_plain(tp, f: int, gen: torch.Generator, what: str) -> float:
    """B2 against gat_bcsr_plain on signed N(0, 1) h: att at scale 0.1
    unshifted and with the exact row shift, att at scale 15 (wide logits)
    shifted only.  num is signed (max bound only), den nonnegative (max
    bound and the gate).  B5 against bcsr_rowmax_plain on each att's src
    half: exactly equal.  Returns max|d| of num."""
    err = 0.0
    h = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    for scale, shifts in ((0.1, (False, True)), (15.0, (True,))):
        att = torch.randn((tp.num_nodes, 2), generator=gen, device="cuda") * scale
        rmax = bcsr_rowmax(tp, att[:, 1].contiguous())
        want = bcsr_rowmax_plain(tp, att[:, 1].contiguous())
        torch.cuda.synchronize()
        check(torch.equal(rmax, want), f"{what} B5 differs from bcsr_rowmax_plain (scale {scale})")
        if f == BENCH_DIMS[1]:
            log(f"  {what} B5 scale {scale}: equal, {int(torch.isneginf(rmax).sum())} rows -inf")
        for shift in shifts:
            row_shift = _hybrid_row_shift(tp, None, att, DEFAULT_SLOPE) if shift else None
            num, den = gat_bcsr(tp, h, att, row_shift=row_shift, dot_mode="split2")
            ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
            torch.cuda.synchronize()
            label = f"{what} f={f} scale {scale}{' shifted' if shift else ''}"
            err = max(err, compare(num, ref_num, f"{label} num", gate=False))
            compare(den, ref_den, f"{label} den", gate=True)
    return err


def gat_edge_oracle(feat, att, dst, src, slope=DEFAULT_SLOPE):
    """float64 GAT aggregation over the edge list (index_add_): softmax over
    each row's in-edges of exp(leaky_relu(att[dst, 0] + att[src, 1]))."""
    z = att[dst, 0] + att[src, 1]
    score = torch.exp(torch.maximum(z, slope * z))
    num = edge_sum(feat, dst, src, score)
    den = torch.zeros(feat.shape[0], dtype=feat.dtype, device=feat.device).index_add_(0, dst, score)
    return num / torch.where(den == 0, 1.0, den)[:, None]


def gat_gates(agg, params, h0, out, g, what: str, layer_limit: float = 0.0, stabilize=False,
              dot_mode: str = "split2") -> list:
    """Phase 6's checks of a GAT forward (fast=True, ``dot_mode``, ``stabilize``)
    over ``agg`` (an aggregator or a gather plan): each layer, from its own
    float32 input, against the float64 edge-list
    oracle (the softmax over each row's in-edges, with multiplicity) misses
    the gate on at most ``layer_limit`` of its elements (0: none), and the
    whole chain ``out`` on at most PURE_BAD_FRACTION.  Returns the layer
    inputs and outputs."""
    g_dst, g_src = edge_lists(g, h0.device)
    xs, chain = [h0], h0.double()
    for i, p in enumerate(params):
        xs.append(gat_forward(agg, [p], xs[i], fast=True, dot_mode=dot_mode, stabilize=stabilize))
        feat = xs[i].double() @ p.w.double()
        ref = gat_edge_oracle(feat, feat @ p.w_att.double(), g_dst, g_src)
        bad = relative_error_count(xs[-1], ref)
        log(f"  {what}layer {i + 1} (same input) vs f64 oracle: gate_bad={bad} of {ref.numel()}")
        check(bad <= layer_limit * ref.numel(), f"{what}GAT layer {i + 1} fails the gate against the f64 oracle")
        feat = chain @ p.w.double()
        chain = gat_edge_oracle(feat, feat @ p.w_att.double(), g_dst, g_src)
    bad = relative_error_count(out, chain)
    log(f"  {what}forward vs f64 oracle chain: gate_bad={bad} of {chain.numel()}")
    check(bad <= PURE_BAD_FRACTION * chain.numel(), f"{what}GAT forward: too many elements off the f64 oracle chain")
    return xs


def b2_rows(agg, tp, tp_pack, pack, xs, params) -> list:
    """Phase 7's B2 timing rows over ``tp``, one a GAT layer from its own
    input: the layer's ms, B2 ms a launch (and over ``tp_pack``, padded to
    ``pack``), the plain version, the library yardstick (torch.sparse.mm of
    the tile cells' score CSR, built outside the timed call, against
    [h | 1]) and the bound (A's bytes, h read, dm and as, num and den
    written; 2 (f + 1) FLOPs a nonzero cell)."""
    dev = tp.a.device
    n = tp.num_nodes
    c_dst, c_src, c_cnt = tile_cells(tp)
    nnz = c_cnt.numel()
    move_plan = tp.a.numel() * tp.a.element_size() + 4 * (tp.num_tiles + tp.num_row_tiles + 1)
    rows = []
    for i, p in enumerate(params):
        layer_ms = cuda_time_ms(lambda: gat_forward(agg, [p], xs[i], fast=True, dot_mode="split2"))
        feat = (xs[i] @ p.w).contiguous()
        att = feat @ p.w_att
        f = feat.shape[1]
        dm, asrc = _score_terms(att)
        ms = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, feat, dm, asrc, DEFAULT_SLOPE))
        ms_pack = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp_pack, feat, dm, asrc, DEFAULT_SLOPE))
        plain_ms = cuda_time_ms(lambda: gat_bcsr_plain(tp, feat, att))
        z = att[c_dst, 0] + att[c_src, 1]
        score = c_cnt.float() * torch.exp(torch.maximum(z, DEFAULT_SLOPE * z))
        csr = torch.sparse_coo_tensor(torch.stack([c_dst, c_src]), score, (n, tp.n_src)).coalesce().to_sparse_csr()
        hx = torch.cat([feat, torch.ones((feat.shape[0], 1), device=dev)], dim=1)
        library_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, hx))
        rows.append(dict(
            f=f, layer_ms=layer_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms, tiles=tp.num_tiles, nnz_cells=nnz,
            **{f"ms_pack{pack}": ms_pack},
            **bound(move_plan + 4 * f * tp.n_src + 8 * n + 4 * tp.n_src + 4 * (f + 1) * n, 2.0 * nnz * (f + 1)),
        ))
        r = rows[-1]
        log(
            f"  layer {i + 1} f={f}: layer {layer_ms:.3f} ms | B2 over {part_name(tp)} tiles {ms:.3f} ms/launch "
            f"(pack{pack} {ms_pack:.3f}) bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | plain {plain_ms:.3f} | "
            f"torch.sparse.mm {library_ms:.3f}"
        )
        del csr, hx, z, score
    return rows


def b5_rows(tp, tp16, xs, params, pack=16) -> list:
    """Phase 7's B5 timing rows over ``tp`` (ms a launch, over ``tp16`` padded
    to ``pack``, plain, the scatter_reduce yardstick, bound) from each GAT
    layer's att."""
    dev = tp.a.device
    n = tp.num_nodes
    c_dst, c_src, c_cnt = tile_cells(tp)
    move_plan = tp.a.numel() * tp.a.element_size() + 4 * (tp.num_tiles + tp.num_row_tiles + 1)
    rows = []
    for i, p in enumerate(params):
        asrc = ((xs[i] @ p.w) @ p.w_att)[:, 1].contiguous()
        rows.append(dict(
            layer=i + 1, tiles=tp.num_tiles, nnz_cells=c_cnt.numel(),
            ms=cuda_time_ms(lambda: cuda_rowmax.rowmax_bcsr_cuda(tp, asrc)),
            **{f"ms_pack{pack}": cuda_time_ms(lambda: cuda_rowmax.rowmax_bcsr_cuda(tp16, asrc))},
            plain_ms=cuda_time_ms(lambda: bcsr_rowmax_plain(tp, asrc)),
            library_ms=cuda_time_ms(
                lambda: torch.full((n,), float("-inf"), device=dev).scatter_reduce_(
                    0, c_dst, asrc.index_select(0, c_src), "amax"
                )
            ),
            **bound(move_plan + 4 * (tp.n_src + n), c_cnt.numel()),
        ))
        r = rows[-1]
        log(
            f"  layer {i + 1}: B5 over {tp.num_tiles} {part_name(tp)} tiles {r['ms']:.3f} ms/launch "
            f"(pack{pack} {r[f'ms_pack{pack}']:.3f}) bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) | plain {r['plain_ms']:.3f} | scatter_reduce {r['library_ms']:.3f}"
        )
    return rows


def gat_phases(args, g, h0, gen, forwards, libs) -> tuple:
    """Phases 5-7: the GAT kernels and the GAT forward.  Returns the B2 and
    B5 entries of the kernels line, and phase 6's un-stabilized and
    stabilize=True outputs."""
    dev = h0.device
    n = g.num_nodes
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **GAT_SCHEDULE)
    tile_host, _ = densify(g, dtype=np.int8, **GAT_SCHEDULE)
    tile16 = tile_host.pad_runs(16).to(dev)
    tp = agg.tile
    log(
        f"GAT plan ({args.scale}): tiles={tp.num_tiles} (pack16: {tile16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} "
        f"tasks={agg.plan.num_tasks} longest run={int(np.diff(tile_host.run_start).max())} "
        f"built in {time.perf_counter() - t0:.1f} s"
    )
    walk_plan = walk_line(tp, f"GAT plan ({args.scale})")

    # ---- phase 5: B2 and B5 against their plain versions
    log("phase 5: B2 kernel vs gat_bcsr_plain, B5 kernel vs bcsr_rowmax_plain")
    max_err = 0.0
    with torch.no_grad():
        for plan, label in ((tp, "pack1"), (tile16, "pack16")):
            for f in BENCH_DIMS[1:]:
                err = gat_kernel_vs_plain(plan, f, gen, label)
                if plan is tp:
                    max_err = max(max_err, err)
        ng, _ = ragged_graph()
        ragged = densify(ng, dtype=np.int8, **GAT_SCHEDULE)[0].pad_runs(16)
        filler_runs = filler_only_runs(ragged)
        check(ng.num_nodes % GAT_SCHEDULE["tile_rows"] != 0 and filler_runs, "GAT ragged case lacks a filler-only run")
        log(f"  ragged raw-count plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={filler_runs}")
        ragged = ragged.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            gat_kernel_vs_plain(ragged, f, gen, "ragged")
        del ragged

    # ---- phase 6: the GAT forward
    log("phase 6: 3-layer GAT forward, fast=True, dot_mode='split2'")
    model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    params = model.layer_params()

    def fwd(**kw):
        return model(agg, h0, fast=True, dot_mode="split2", **kw)

    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = fwd()
        torch.cuda.synchronize()
        launches = cuda_gat.launches
        log(f"  B2 launches in {forwards} forwards: {launches}; B5: {cuda_rowmax.launches}; B1: {cuda_bcsr.launches}")
        check(launches == 3 * forwards, "B2 did not launch 3 times per forward")
        check(only("B2"), "the GAT forward launched another kernel")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "GAT forward output")

        xs = gat_gates(agg, params, h0, out, g, "")

        # the stabilized forward is its own path: B5 runs only there
        reset_counts()
        out_exact = fwd(stabilize=True)
        torch.cuda.synchronize()
        rowmax_launches = cuda_rowmax.launches
        log(f"  stabilize=True forward: B5 launches {rowmax_launches}, B2 {cuda_gat.launches}")
        check(rowmax_launches == 3 and cuda_gat.launches == 3, "stabilized forward: B5 or B2 not launched 3 times")
        reset_counts()
        out_bound = fwd(stabilize="bound")
        torch.cuda.synchronize()
        check(cuda_rowmax.launches == 0 and cuda_gat.launches == 3, "stabilize='bound' forward launches")
        for label, o in (("stabilize=True", out_exact), ("stabilize='bound'", out_bound)):
            bad = relative_error_count(o, out)
            log(f"  {label} vs un-stabilized: gate_bad={bad}")
            check(bool(torch.isfinite(o).all()) and bad == 0, f"{label} forward differs from the un-stabilized one")

        # ---- phase 7: timing
        log("phase 7: GAT timing (CUDA events, median of 10 after 3 warm-up)")
        fwd_ms = cuda_time_ms(fwd)
        stab_ms = cuda_time_ms(lambda: fwd(stabilize=True))
        bound_fwd_ms = cuda_time_ms(lambda: fwd(stabilize="bound"))
        log(f"  forward: {fwd_ms:.3f} ms; stabilize=True {stab_ms:.3f} ms; stabilize='bound' {bound_fwd_ms:.3f} ms")
        b2 = b2_rows(agg, tp, tile16, 16, xs, params)
        rows5 = b5_rows(tp, tile16, xs, params)

    def total(rows, k):
        return sum(r[k] for r in rows)

    def entry(name, replaces, rows, launches, max_abs_err, **extra):
        return dict(
            name=name, route="cuda", source=f"gnn_computing_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches, max_abs_err=max_abs_err,
            # times summed over the three launches of one forward
            ms=total(rows, "ms"), plain_ms=total(rows, "plain_ms"), bound_ms=total(rows, "bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            library_ms=total(rows, "library_ms"), scale=args.scale, shapes=rows, **extra,
        )

    return [
        entry("gat_bcsr", "gnn_computing_tpu/ops/pallas_bcsr.py:436", b2, launches, max_err,
              path="GAT forward (fast, split2)", forward_ms=fwd_ms, build_s=libs["gat_bcsr"][1], walk="cell",
              walk_plan=walk_plan),
        entry("rowmax_bcsr", "gnn_computing_tpu/ops/pallas_bcsr.py:1251", rows5, rowmax_launches, 0.0,
              path="GAT forward (fast, split2, stabilize=True)", forward_ms=stab_ms,
              bound_forward_ms=bound_fwd_ms, build_s=libs["rowmax_bcsr"][1], walk="cell",
              walk_plan=walk_line(tp, f"GAT plan ({args.scale})")),
    ], dict(out=out, out_exact=out_exact)


def edge_sum_ad(z: torch.Tensor, dst, src, weight=None) -> torch.Tensor:
    """out[dst[e]] += weight[e] * z[src[e]], differentiable (no in-place on
    a tensor autograd keeps)."""
    msg = z.index_select(0, src)
    if weight is not None:
        msg = msg * weight[:, None]
    return torch.zeros_like(z).index_add(0, dst, msg)


def gat_edge_oracle_ad(feat, att, dst, src, kink_pos=None, slope=DEFAULT_SLOPE, rounded=None):
    """gat_edge_oracle in a differentiable form (float64 autograd oracle).
    ``kink_pos`` (per edge) gives the side of leaky-relu's kink for the
    edges whose logit lies within KINK of it.

    ``rounded`` (dot_mode 'default'): the port's forward output on the same
    inputs, whose numerator took bf16-rounded scores and h.  The oracle's
    value is then ``rounded`` and its gradient the rule of the backward of a
    'default' forward (the JAX package's): the exact formulas, with the
    row term c_i = <ct_i, out_i> / den_i taken from the rounded output:
    d/dz_ij = s_ij lrelu'_ij (<ct_i, h_j> - <ct_i, rounded_i>) / den_i."""
    z = att[dst, 0] + att[src, 1]
    pos = z > 0
    if kink_pos is not None:
        pos = torch.where(z.abs() < KINK, kink_pos, pos)
    score = torch.exp(torch.where(pos, z, slope * z))
    den = torch.zeros(feat.shape[0], dtype=feat.dtype, device=feat.device).index_add(0, dst, score)
    safe = torch.where(den == 0, 1.0, den)[:, None]
    num = edge_sum_ad(feat, dst, src, score)
    if rounded is None:
        return num / safe
    p, sd = rounded.detach().double(), safe.detach()
    # value p (den / sd is 1, or 0 on a row without edges, whose p is 0);
    # gradient d num / den - p d den / den
    return num / sd - p * (den[:, None] / sd) + (2.0 * p - num.detach() / sd)


def cotangent(shape, device) -> torch.Tensor:
    """An O(1) signed float64 cotangent, cos(arange), as
    tests/test_gat_streaming_bwd.py uses."""
    numel = int(np.prod(shape))
    return torch.cos(torch.arange(numel, dtype=torch.float64, device=device)).reshape(shape)


def port_kink_sides(att, parts, dst, src) -> torch.Tensor:
    """For the edges (dst, src): whether the port's float32 branch test puts
    them on the z > 0 side, with the 'bound' shift of ``att``: the tile
    cells' test z >= 0 and the residual's exp(lrelu(z) - M) > exp(-M), the
    same operations on the same device.  Where the two tests
    differ, the edge's place (a tile cell with a count in one of the tile
    ``parts``, else the residual) decides; a cell at the int8 cap, whose
    edges lie on both sides, raises."""
    shift = _global_bound_shift(att, DEFAULT_SLOPE)
    z = att[:, 0].index_select(0, dst) + att[:, 1].index_select(0, src)
    pos_tile = z >= 0
    sh = shift.index_select(0, dst)
    pos_res = torch.exp(torch.maximum(z, z * DEFAULT_SLOPE) - sh) > torch.exp(-sh)
    differ = pos_tile != pos_res
    if not bool(differ.any()):
        return pos_tile
    d, s_ = dst[differ], src[differ]
    cnt = torch.zeros_like(d)
    for tp in parts:
        tile_map = torch.full((tp.num_row_tiles, tp.num_col_tiles), -1, dtype=torch.long, device=dst.device)
        tile_map[tp.tile_row.long(), tp.tile_col.long()] = torch.arange(tp.num_tiles, device=dst.device)
        t = tile_map[d // tp.tile_rows, s_ // tp.tile_cols]
        cnt += torch.where(t >= 0, cell_counts(tp, t.clamp_min(0), d % tp.tile_rows, s_ % tp.tile_cols), 0)
    check(not bool((cnt == 127).any()), "a near-kink edge lies in a cell at the int8 cap")
    pos = pos_tile.clone()
    pos[differ] = torch.where(cnt > 0, pos_tile[differ], pos_res[differ])
    return pos


def grad_gate(got, want, what: str):
    """At most PURE_BAD_FRACTION of the elements may miss the gate."""
    bad = relative_error_count(got, want)
    err = (got.double() - want).abs().max().item()
    log(f"  {what}: gate_bad={bad} of {want.numel()} max|d|={err:.3e} max|ref|={want.abs().max().item():.3e}")
    check(bad <= PURE_BAD_FRACTION * want.numel(), f"{what}: too many elements off the float64 autograd oracle")


def rel_l2(got, want) -> float:
    return ((got.double() - want).norm() / want.norm()).item()


def bwd_inputs(n, f, scale, shift, gen, dev):
    """(h, gbar, c, dm, asrc) for the backward kernels: N(0, 1) h, gbar and
    c; att at ``scale``, with the 'bound' shift in dm if asked."""
    h = torch.randn((n, f), generator=gen, device=dev)
    gbar = torch.randn((n, f), generator=gen, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    att = torch.randn((n, 2), generator=gen, device=dev) * scale
    dm, asrc = _score_terms(att, _global_bound_shift(att, DEFAULT_SLOPE) if shift else None)
    return h, gbar, c, dm, asrc


def bwd_kernels_vs_plain(tp, tp_t, f, gen, what) -> float:
    """B3 over ``tp`` and B4 over ``tp_t`` against their plain versions, att
    at scale 0.1 unshifted and at scale 15 with the 'bound' shift.  Returns
    max|d| over the three outputs."""
    err = 0.0
    for scale, shift in ((0.1, False), (15.0, True)):
        args = bwd_inputs(tp.num_nodes, f, scale, shift, gen, tp.a.device) + (DEFAULT_SLOPE,)
        dad = gat_bwd_dad(tp, *args)
        dh, das = gat_bwd_dh_das(tp_t, *args)
        want_dad = gat_bwd_dad_plain(tp, *args)
        want_dh, want_das = gat_bwd_dh_das_plain(tp_t, *args)
        torch.cuda.synchronize()
        label = f"{what} f={f} scale {scale}{' bound-shifted' if shift else ''}"
        for got, want, out in ((dad, want_dad, "d_ad"), (dh, want_dh, "dh"), (das, want_das, "d_as")):
            err = max(err, compare(got, want, f"{label} {out}", gate=False))
    return err


def bound(nbytes, flops) -> dict:
    """The least time for ``nbytes`` moved and ``flops`` float32 operations."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return dict(bound_ms=max(b_ms, o_ms), bound_by="bytes" if b_ms >= o_ms else "operations")


def cells_csr(rows, cols, vals, shape) -> torch.Tensor:
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce().to_sparse_csr()


def csr_rows(m: torch.Tensor) -> torch.Tensor:
    """The row of every stored value of a CSR matrix."""
    crow = m.crow_indices()
    return torch.repeat_interleave(torch.arange(crow.numel() - 1, device=crow.device), crow.diff())


def train_kernel_times(tp, tp_t, tile16, tile_t16, gen) -> dict:
    """Phase 11's kernel rows: B3, B4, B1 over tp_t and B2 at each f, ms per
    launch (pack 1 and 16), bound, plain ms and library yardstick ms."""
    dev = tp.a.device
    n = tp.num_nodes
    c_dst, c_src, c_cnt = tile_cells(tp)
    nnz = c_cnt.numel()
    idx = 4 * (tp.num_tiles + tp.num_row_tiles + 1)
    idx_t = 4 * (tp_t.num_tiles + tp_t.num_row_tiles + 1)
    a_bytes, a_bytes_t = tp.a.numel() * tp.a.element_size(), tp_t.a.numel() * tp_t.a.element_size()
    csr_t = tile_csr(tp_t)
    rows = {"B3": [], "B4": [], "B1_t": [], "B2": []}
    for f in BENCH_DIMS[1:]:
        h, gbar, c, dm, asrc = bwd_inputs(n, f, 1.0, True, gen, dev)
        args = (h, gbar, c, dm, asrc, DEFAULT_SLOPE)
        # the cells' scores and lrelu' * score, as CSRs in the forward and the
        # transposed orientation, built outside the timed calls
        z = dm[c_dst, 0] + asrc[c_src]
        score = c_cnt.float() * torch.exp(torch.maximum(z, DEFAULT_SLOPE * z) - dm[c_dst, 1])
        wgt = torch.where(z >= 0, 1.0, DEFAULT_SLOPE) * score
        pat, pat_t = cells_csr(c_dst, c_src, wgt, (n, n)), cells_csr(c_src, c_dst, wgt, (n, n))
        s_fwd, s_t = cells_csr(c_dst, c_src, score, (n, n)), cells_csr(c_src, c_dst, score, (n, n))
        rows_f, rows_t = csr_rows(pat), csr_rows(pat_t)
        c_f, c_t = c.index_select(0, rows_f), c.index_select(0, pat_t.col_indices())
        ht, gbart = h.t().contiguous(), gbar.t().contiguous()
        h1 = torch.cat([h, torch.ones((n, 1), device=dev)], dim=1)

        def lib_dad():
            p = torch.sparse.sampled_addmm(pat, gbar, ht, beta=0.0)
            return torch.zeros(n, device=dev).index_add_(0, rows_f, pat.values() * (p.values() - c_f))

        def lib_dh_das():
            p = torch.sparse.sampled_addmm(pat_t, h, gbart, beta=0.0)
            d_as = torch.zeros(n, device=dev).index_add_(0, rows_t, pat_t.values() * (p.values() - c_t))
            return torch.sparse.mm(s_t, gbar), d_as

        # the yardsticks compute the kernels' functions
        want_dad = gat_bwd_dad_plain(tp, *args)
        want_dh, want_das = gat_bwd_dh_das_plain(tp_t, *args)
        got_dh, got_das = lib_dh_das()
        for got, want, what in ((lib_dad(), want_dad, "B3"), (got_dh, want_dh, "B4 dh"), (got_das, want_das, "B4 d_as")):
            check((got - want).abs().max() <= 1e-4 * want.abs().max(), f"{what} library yardstick disagrees at f={f}")
        io = 4 * f * 2 * n + 12 * n + 4 * n  # h, gbar, dm, asrc, c
        r3 = dict(
            f=f, ms=cuda_time_ms(lambda: gat_bwd_dad(tp, *args)),
            ms_pack16=cuda_time_ms(lambda: gat_bwd_dad(tile16, *args)),
            plain_ms=cuda_time_ms(lambda: gat_bwd_dad_plain(tp, *args)),
            library_ms=cuda_time_ms(lib_dad), nnz_cells=nnz,
            **bound(a_bytes + idx + io + 4 * n, 2.0 * nnz * f),
        )
        r4 = dict(
            f=f, ms=cuda_time_ms(lambda: gat_bwd_dh_das(tp_t, *args)),
            ms_pack16=cuda_time_ms(lambda: gat_bwd_dh_das(tile_t16, *args)),
            plain_ms=cuda_time_ms(lambda: gat_bwd_dh_das_plain(tp_t, *args)),
            library_ms=cuda_time_ms(lib_dh_das), nnz_cells=nnz,
            **bound(a_bytes_t + idx_t + io + 4 * n * (f + 1), 4.0 * nnz * f),
        )
        r1 = dict(
            f=f, ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp_t, gbar)),
            ms_pack16=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tile_t16, gbar)),
            plain_ms=cuda_time_ms(lambda: bcsr_spmm_plain(tp_t, gbar)),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr_t, gbar)), nnz_cells=nnz,
            **bound(a_bytes_t + idx_t + 8 * f * n, 2.0 * nnz * f),
        )
        att = torch.randn((n, 2), generator=gen, device=dev)
        dma, asa = _score_terms(att)
        r2 = dict(
            f=f, ms=cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, h, dma, asa, DEFAULT_SLOPE)),
            ms_pack16=cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tile16, h, dma, asa, DEFAULT_SLOPE)),
            plain_ms=cuda_time_ms(lambda: gat_bcsr_plain(tp, h, att)),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(s_fwd, h1)), nnz_cells=nnz,
            **bound(a_bytes + idx + 4 * f * n + 12 * n + 4 * (f + 1) * n, 2.0 * nnz * (f + 1)),
        )
        for k, r in (("B3", r3), ("B4", r4), ("B1_t", r1), ("B2", r2)):
            r["tiles"] = (tp_t if k in ("B4", "B1_t") else tp).num_tiles
            rows[k].append(r)
        for k, r in (("B3", r3), ("B4", r4), ("B1 transposed", r1), ("B2 [256, 256]", r2)):
            log(
                f"  f={f} {k}: {r['ms']:.3f} ms/launch (pack16 {r['ms_pack16']:.3f}) bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}) | plain {r['plain_ms']:.3f} | library {r['library_ms']:.3f}"
            )
        del pat, pat_t, s_fwd, s_t, z, score, wgt, h1
    return rows


def train_labels(n: int, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(7).integers(0, BENCH_DIMS[-1], n)).to(dev)


def gcn_training(agg, g, h0, what: str, val=None) -> dict:
    """Phase 9's checks and steps over ``agg`` (a schedule with transposed
    plans; ``val`` the graph's edge values where it is weighted), from
    glorot_weights (seed 0): at the initial weights, per layer
    from its own float32 input and a cos(arange) cotangent, the
    aggregation's input gradient against float64 autograd through an
    index_add_ edge-list oracle (at most PURE_BAD_FRACTION bad), and each
    weight gradient of the whole step within GRAD_REL_L2 of the float64
    chain's; then TRAIN_STEPS steps of make_train_step, the launch counts
    set to 0 just before and read just after.  Returns the model, its
    forward and step, the layer inputs, the first step's weight gradients,
    the counts and the losses."""
    dev = h0.device
    g_dst, g_src = edge_lists(g, dev)
    g_w = None if val is None else torch.from_numpy(np.asarray(val, np.float64)).to(dev)
    labels = train_labels(g.num_nodes, dev)
    gcn = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)

    def fwd(h):
        return gcn(agg, h)

    with torch.no_grad():
        xs = [h0]
        for w in gcn.weights:
            xs.append(gcn_layer(agg, xs[-1], w))
    for i, w in enumerate(gcn.weights):
        with torch.no_grad():
            z = xs[i] @ w
        z.requires_grad_(True)
        ct = cotangent(tuple(z.shape), dev)
        (agg.run(z) * ct.float()).sum().backward()
        z64 = z.detach().double().requires_grad_(True)
        (edge_sum_ad(z64, g_dst, g_src, g_w) * ct).sum().backward()
        grad_gate(z.grad, z64.grad, f"{what}GCN layer {i + 1} aggregation input gradient vs f64 autograd")
        del z, z64, ct
    loss = softmax_xent(fwd(h0), labels)
    loss.backward()
    grads0 = [w.grad.detach().clone() for w in gcn.weights]
    ws = [w.detach().double().requires_grad_(True) for w in gcn.weights]
    x = h0.double()
    for w in ws:
        x = torch.relu(edge_sum_ad(x @ w, g_dst, g_src, g_w))
    loss64 = torch.nn.functional.cross_entropy(x, labels)
    loss64.backward()
    log(f"  one step's loss {loss.item():.7f}, f64 chain {loss64.item():.7f}")
    for i, (g32, w64) in enumerate(zip(grads0, ws)):
        r = rel_l2(g32, w64.grad)
        log(f"  {what}GCN w{i + 1} gradient vs f64 chain: relative L2 {r:.3e}")
        check(r <= GRAD_REL_L2, f"{what}GCN w{i + 1} gradient off the float64 chain")
    del ws, x, loss64, g_dst, g_src, g_w
    gcn.zero_grad(set_to_none=True)
    step = make_train_step(fwd, torch.optim.Adam(gcn.parameters(), lr=1e-3), device=dev)
    reset_counts()
    losses = [step((h0,), labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    c, cb = counts(), bit_counts()
    losses = [float(v) for v in losses]
    log(f"  losses {losses}; launches in {TRAIN_STEPS} steps: {c}, 1-bit among them: {cb}")
    check(all(np.isfinite(losses)), f"{what}GCN training loss not finite")
    return dict(model=gcn, fwd=fwd, step=lambda: step((h0,), labels), xs=xs, grads0=grads0, counts=c,
                bit_counts=cb, losses=losses)


def gat_training(agg, g, h0, what: str, dot_mode: str = "split2") -> dict:
    """Phase 10's checks and steps over ``agg``: gcn_training's with
    gat_forward(fast=False, stabilize='bound', dot_mode) and
    glorot_gat_weights (seed 0); the per-layer check is on (dh, datt)
    against float64 autograd of the edge-list GAT oracle, which takes the
    port's side of leaky-relu's kink for edges within KINK of it; the first
    step's gradients of w and w_att are held to GRAD_REL_L2 (relative L2)
    of the float64 chain's.  Under dot_mode 'default' the oracle of each
    layer takes the port's rounded output as its value and the rule of its
    backward (gat_edge_oracle_ad's ``rounded``): the rounding itself is
    held to its plain version in phase 34."""
    dev = h0.device
    g_dst, g_src = edge_lists(g, dev)
    labels = train_labels(g.num_nodes, dev)
    gat = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)

    def fwd(h):
        return gat(agg, h, fast=False, stabilize="bound", dot_mode=dot_mode)

    def one(h, p):
        return gat_forward(agg, [p], h, fast=False, stabilize="bound", dot_mode=dot_mode)

    with torch.no_grad():
        gxs = [h0]
        for p in gat.layer_params():
            gxs.append(one(gxs[-1], p))
    kink_pos = []  # per layer, the port's side of the kink for every edge
    for i, p in enumerate(gat.layer_params()):
        with torch.no_grad():
            feat = gxs[i] @ p.w
            att = feat @ p.w_att
            kink_pos.append(port_kink_sides(att, agg.tile_parts(), g_dst, g_src))
            z = att[g_dst, 0].double() + att[g_src, 1].double()
        log(f"  {what}GAT layer {i + 1}: {int((z.abs() < KINK).sum())} edges within {KINK} of leaky-relu's kink")
        feat.requires_grad_(True)
        att.requires_grad_(True)
        ct = cotangent(tuple(feat.shape), dev)
        out = agg.run_gat(feat, att, stabilize="bound", dot_mode=dot_mode)
        (out * ct.float()).sum().backward()
        f64 = feat.detach().double().requires_grad_(True)
        a64 = att.detach().double().requires_grad_(True)
        rounded = out if dot_mode == "default" else None
        (gat_edge_oracle_ad(f64, a64, g_dst, g_src, kink_pos[i], rounded=rounded) * ct).sum().backward()
        grad_gate(feat.grad, f64.grad, f"{what}GAT layer {i + 1} dh vs f64 autograd")
        grad_gate(att.grad, a64.grad, f"{what}GAT layer {i + 1} datt vs f64 autograd")
        del f64, a64, ct, out, rounded, feat, att, z
    loss = softmax_xent(fwd(h0), labels)
    loss.backward()
    grads0 = [(p.w.grad.detach().clone(), p.w_att.grad.detach().clone()) for p in gat.layer_params()]
    ps = [(p.w.detach().double().requires_grad_(True), p.w_att.detach().double().requires_grad_(True))
          for p in gat.layer_params()]
    x = h0.double()
    for i, ((w, a), pos) in enumerate(zip(ps, kink_pos)):
        feat = x @ w
        x = gat_edge_oracle_ad(feat, feat @ a, g_dst, g_src, pos, rounded=gxs[i + 1] if dot_mode == "default" else None)
    loss64 = torch.nn.functional.cross_entropy(x, labels)
    loss64.backward()
    log(f"  one step's loss {loss.item():.7f}, f64 chain {loss64.item():.7f}")
    chain = [(w64.grad.detach(), a64.grad.detach()) for w64, a64 in ps]
    rels = grad_readings(grads0, chain, f"{what}GAT")
    for i, (rw, ra) in enumerate(rels):
        check(rw <= GRAD_REL_L2 and ra <= GRAD_REL_L2, f"{what}GAT layer {i + 1} gradient off the float64 chain")
    del ps, x, feat, loss64, g_dst, g_src, kink_pos
    gat.zero_grad(set_to_none=True)
    step = make_train_step(fwd, torch.optim.Adam(gat.parameters(), lr=1e-3), device=dev)
    reset_counts()
    losses = [step((h0,), labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    c, cb = counts(), bit_counts()
    default_launches = cuda_gat.default_launches
    losses = [float(v) for v in losses]
    log(f"  losses {losses}; launches in {TRAIN_STEPS} steps: {c}, 1-bit among them: {cb}, "
        f"B2 'default' among them: {default_launches}")
    check(all(np.isfinite(losses)), f"{what}GAT training loss not finite")
    check(default_launches == (c["B2"] if dot_mode == "default" else 0), f"{what}GAT training: B2 'default' launches")
    return dict(model=gat, fwd=fwd, one=one, step=lambda: step((h0,), labels), xs=gxs, grads0=grads0,
                counts=c, bit_counts=cb, losses=losses, rel_l2=rels, default_launches=default_launches,
                chain=chain, labels=labels)


def grad_readings(grads, chain, what: str) -> list:
    """Per layer, the relative L2 of the first step's (w, w_att) gradients
    against the float64 chain's, logged with GRAD_REL_L2."""
    rels = []
    for i, ((gw, ga), (cw, ca)) in enumerate(zip(grads, chain)):
        rels.append((rel_l2(gw, cw), rel_l2(ga, ca)))
        log(f"  {what} layer {i + 1} gradient vs f64 chain: w relative L2 {rels[-1][0]:.3e}, w_att "
            f"{rels[-1][1]:.3e} (bound {GRAD_REL_L2:g})")
    return rels


def step_times(gcn: dict, gat: dict, h0) -> dict:
    """Train-step, forward and backward + Adam ms of a GCN and a GAT run."""
    times = dict(
        gcn_step_ms=cuda_time_ms(gcn["step"]),
        gcn_forward_ms=cuda_time_ms(lambda: gcn["fwd"](h0)),
        gat_step_ms=cuda_time_ms(gat["step"]),
        gat_forward_ms=cuda_time_ms(lambda: gat["fwd"](h0)),
    )
    for m in ("gcn", "gat"):
        times[f"{m}_backward_adam_ms"] = times[f"{m}_step_ms"] - times[f"{m}_forward_ms"]
        log(
            f"  {m.upper()} step {times[f'{m}_step_ms']:.3f} ms = forward {times[f'{m}_forward_ms']:.3f} "
            f"+ backward and Adam {times[f'{m}_backward_adam_ms']:.3f}"
        )
    return times


def train_phases(args, g, h0, gen) -> dict:
    """Phases 8-11: the backward kernels, then the GCN and GAT training
    steps.  Returns the kernel rows, launch counts, losses, times and the
    first steps' weight gradients."""
    dev = h0.device
    n = g.num_nodes
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=1, with_transpose=True, device=dev, **TRAIN_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    tile_host, _ = densify(g, dtype=np.int8, **TRAIN_SCHEDULE)
    tile_t_host = tile_host.transpose()
    tile16, tile_t16 = tile_host.pad_runs(16).to(dev), tile_t_host.pad_runs(16).to(dev)
    tp, tp_t = agg.tile, agg.tile_t
    log(
        f"training plan ({args.scale}): tiles={tp.num_tiles} (pack16: {tile16.num_tiles}), transposed "
        f"{tp_t.num_tiles} ({tp_t.num_tiles - tp.num_tiles} coverage fillers; pack16: {tile_t16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} tasks={agg.plan.num_tasks} "
        f"(transposed {agg.plan_t.num_tasks}) longest run={int(np.diff(tile_host.run_start).max())} "
        f"(transposed {int(np.diff(tile_t_host.run_start).max())}) built in {build_s:.1f} s"
    )
    del tile_host, tile_t_host

    # ---- phase 8: the kernels of the training path against their plain versions
    log("phase 8: B3 vs gat_bwd_dad_plain, B4 vs gat_bwd_dh_das_plain, B1 transposed, B2 at [256, 256]")
    max_err = {"B3": 0.0, "B1_t": 0.0, "B2": 0.0}
    with torch.no_grad():
        for (p, p_t), label in (((tp, tp_t), "pack1"), ((tile16, tile_t16), "pack16")):
            for f in BENCH_DIMS[1:]:
                errs = (
                    bwd_kernels_vs_plain(p, p_t, f, gen, label),
                    kernel_vs_plain(p_t, f, "native", gen, f"{label} transposed"),
                    gat_kernel_vs_plain(p, f, gen, f"{label} [256, 256]"),
                )
                if p is tp:
                    for k, e in zip(("B3", "B1_t", "B2"), errs):
                        max_err[k] = max(max_err[k], e)
        ng, _ = ragged_graph()
        ragged_host = densify(ng, dtype=np.int8, **TRAIN_SCHEDULE)[0]
        ragged, ragged_t = ragged_host.pad_runs(16), ragged_host.transpose().pad_runs(16)
        fillers, fillers_t = filler_only_runs(ragged), filler_only_runs(ragged_t)
        check(bool(fillers) and bool(fillers_t), "training ragged case lacks a filler-only run")
        log(
            f"  ragged raw-count plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={fillers}; "
            f"transposed tiles={ragged_t.num_tiles} filler-only runs={fillers_t}"
        )
        ragged, ragged_t = ragged.to(dev), ragged_t.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            bwd_kernels_vs_plain(ragged, ragged_t, f, gen, "ragged")
            kernel_vs_plain(ragged_t, f, "native", gen, "ragged transposed")
        del ragged, ragged_t

    # ---- phase 9: GCN training
    log(f"phase 9: GCN training, {TRAIN_STEPS} steps of make_train_step (exact modes, Adam 1e-3)")
    gcn = gcn_training(agg, g, h0, "")
    check(gcn["counts"]["B1"] == 6 * TRAIN_STEPS, "GCN training: B1 did not launch 6 times per step")
    check(all(v == 0 for k, v in gcn["counts"].items() if k not in ("B1", "R1")), "GCN training launched a GAT kernel")
    check(gcn["counts"]["R1"] == 2 * TRAIN_STEPS * residual_layers(agg), "GCN training: R1 not 6 launches a step")

    # ---- phase 10: GAT training
    log(f"phase 10: GAT training, {TRAIN_STEPS} steps (fast=False, stabilize='bound', dot_mode='split2')")
    gat = gat_training(agg, g, h0, "")
    for k in ("B2", "B3", "B4"):
        check(gat["counts"][k] == 3 * TRAIN_STEPS, f"GAT training: {k} did not launch 3 times per step")
    check(gat["counts"]["B1"] == 0 and gat["counts"]["B5"] == 0, "GAT training launched B1 or B5")
    check(gat["counts"]["R1"] == 3 * TRAIN_STEPS * min(residual_layers(agg), 1),
          "GAT training: R1 (the residual's dh over the transposed plan) not 3 launches a step")

    # ---- phase 11: timing
    log("phase 11: training timing (CUDA events, median of 10 after 3 warm-up)")
    times = step_times(gcn, gat, h0)
    layers = []
    for i, (w, p) in enumerate(zip(gcn["model"].weights, gat["model"].layer_params())):
        ct = cotangent((n, w.shape[1]), dev).float()
        xi, gxi = gcn["xs"][i], gat["xs"][i]
        row = dict(layer=i + 1, f=int(w.shape[1]))
        row["gcn_forward_ms"] = cuda_time_ms(lambda: gcn_layer(agg, xi, w))
        row["gcn_fwd_bwd_ms"] = cuda_time_ms(lambda: (gcn_layer(agg, xi, w) * ct).sum().backward())
        row["gat_forward_ms"] = cuda_time_ms(lambda: gat["one"](gxi, p))
        row["gat_fwd_bwd_ms"] = cuda_time_ms(lambda: (gat["one"](gxi, p) * ct).sum().backward())
        for m in ("gcn", "gat"):
            row[f"{m}_backward_ms"] = row[f"{m}_fwd_bwd_ms"] - row[f"{m}_forward_ms"]
        layers.append(row)
        log(
            f"  layer {i + 1} f={row['f']}: GCN forward {row['gcn_forward_ms']:.3f} backward "
            f"{row['gcn_backward_ms']:.3f} ms | GAT forward {row['gat_forward_ms']:.3f} backward "
            f"{row['gat_backward_ms']:.3f} ms"
        )
    with torch.no_grad():
        rows = train_kernel_times(tp, tp_t, tile16, tile_t16, gen)
    return dict(
        rows=rows, max_err=max_err, times=times, layers=layers,
        gcn_counts=gcn["counts"], gat_counts=gat["counts"], gcn_losses=gcn["losses"], gat_losses=gat["losses"],
        gcn_grads0=gcn["grads0"], gat_grads0=gat["grads0"],
    )


def tile_slice(tp, start: int, stop: int):
    """Tiles start..stop of a plan, for B6 and its plain version (which read
    neither run_start nor the runs' order)."""
    if start == 0 and stop >= tp.num_tiles:
        return tp
    return dataclasses.replace(
        tp, a=tp.a[start:stop], tile_row=tp.tile_row[start:stop], tile_col=tp.tile_col[start:stop],
        num_tiles=min(stop, tp.num_tiles) - start,
    )


def host_plan(tp):
    """A card plan back on the host (numpy), for pad_runs."""
    return dataclasses.replace(
        tp, a=tp.a.cpu().numpy(), tile_row=tp.tile_row.cpu().numpy(), tile_col=tp.tile_col.cpu().numpy(),
        run_start=tp.run_start.cpu().numpy(),
    )


def part_name(tp) -> str:
    return "1-bit" if tp.bits else tp.format


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def cells_agree(got, want, cnt, what: str) -> float:
    """B6's cells against the plain version's: cells without an edge are
    exactly +0; float32 cells within KERNEL_TOL * max|plain|, bfloat16 cells
    at most one bfloat16 ulp apart.  Returns max|d|."""
    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
    raw = got.view(torch.int16) if got.dtype == torch.bfloat16 else got.view(torch.int32)
    check(not bool(((raw != 0) & (cnt == 0)).any()), f"{what}: a cell without an edge is not +0")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite cell")
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    if got.dtype == torch.bfloat16:
        ulp_bad = int(((g - w).abs() > bf16_ulp(torch.maximum(g.abs(), w.abs()))).sum())
        check(ulp_bad == 0, f"{what}: {ulp_bad} bfloat16 cells more than one ulp from the plain version")
    else:
        check(err <= KERNEL_TOL * scale, f"{what}: disagrees with the plain version")
    return err


def sddmm_vs_plain(tp, f: int, gen, what: str) -> float:
    """B6 against sddmm_bcsr_plain on N(0, 1) a and b, float32 and bfloat16
    cells, CHECK_TILES tiles at a time (any tile format: the cells whose
    value is not > 0 must be +0).  Returns max|d| of the float32 cells."""
    a = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    b = torch.randn((tp.num_nodes, f), generator=gen, device="cuda")
    err, worst = 0.0, {}
    for s in range(0, tp.num_tiles, CHECK_TILES):
        sub = tile_slice(tp, s, s + CHECK_TILES)
        cnt = sub.counts() > 0  # a cell holds an edge where its value is > 0
        for out in (torch.float32, torch.bfloat16):
            got = sddmm_bcsr(sub, a, b, out_dtype=out, dot_mode="split23")
            want = sddmm_bcsr_plain(sub, a, b, out)
            torch.cuda.synchronize()
            e = cells_agree(got, want, cnt, f"{what} f={f} {out}")
            worst[out] = max(worst.get(out, 0.0), e)
            if out == torch.float32:
                err = max(err, e)
            del got, want
    log(
        f"  {what} f={f}: tiles={tp.num_tiles} float32 max|d|={worst[torch.float32]:.3e}, "
        f"bfloat16 max|d|={worst[torch.bfloat16]:.3e} (<= 1 ulp), zero cells +0"
    )
    return err


def sddmm_inf_non_edge(tp, gen):
    """A non-edge cell whose dot overflows to inf must come out +0: its
    column neighbour holds an edge, so the lane computes both dots, and B6
    must select on the count; the other cells of up to CHECK_TILES tiles
    from its tile on agree with the plain version."""
    r, c = tp.tile_rows, tp.tile_cols
    t = i = j = None
    for t in range(tp.num_tiles):
        # non-edges whose pair neighbour (column j ^ 1) is an edge
        cnt = tp.counts(t, t + 1)[0]
        pair = cnt.reshape(r, c // 2, 2).flip(-1).reshape(r, c)
        cand = ((cnt == 0) & (pair > 0)).nonzero()
        if cand.shape[0]:
            i, j = (int(x) for x in cand[0])
            break
    check(i is not None, "no non-edge beside an edge")
    row, col = tp.tile_row[t].item() * tp.tile_rows + i, tp.tile_col[t].item() * tp.tile_cols + j
    tp = tile_slice(tp, t, t + CHECK_TILES)  # the chosen tile is now tile 0
    cnt, t = tp.counts(), 0
    a = torch.randn((tp.n_src, SDDMM_F), generator=gen, device="cuda")
    b = torch.randn((tp.num_nodes, SDDMM_F), generator=gen, device="cuda")
    a[col] = 1e30
    b[row] = 1e30
    check(bool(torch.isinf((a[col] * b[row]).sum())), "the chosen non-edge's dot does not overflow")
    for out in (torch.float32, torch.bfloat16):
        got = sddmm_bcsr(tp, a, b, out_dtype=out)
        want = sddmm_bcsr_plain(tp, a, b, out)
        torch.cuda.synchronize()
        check(got[t, i, j].float().item() == 0.0, f"a non-edge with an inf dot gave {got[t, i, j].item()}")
        cells_agree(got, want, cnt, f"{part_name(tp)} inf non-edge {out}")
    log(f"  {part_name(tp)} non-edge cell ({row}, {col}) with an inf dot: +0")


def cell_counts(tp, t, i, j) -> torch.Tensor:
    """Counts of cells (t, i, j) of a plan, either format."""
    if not tp.bits:
        return tp.a[t, i, j].long()
    r8 = tp.tile_rows // 8
    return (tp.a[t, i % r8, j].long() >> (i // r8)) & 1


def sddmm_path_checks(g, agg, cells, res, a, b):
    """Phase 13's checks: every cell without an edge is +0; every edge of
    the graph maps through its part's (row-tile, col-tile) -> tile index to
    a cell with an edge whose value passes the gate against the float64
    dot, or is a residual edge; every residual slot passes the gate and pad
    slots are 0; dense edges + residual edges = m."""
    dev = a.device
    m = g.num_edges
    a64, b64 = a.double(), b.double()
    parts = agg.tile_parts()
    maps, dense_edges = [], 0
    for p, c in zip(parts, cells):
        check(c.dtype == torch.bfloat16 and c.shape == (p.num_tiles, p.tile_rows, p.tile_cols), "cell array shape")
        real = torch.zeros(p.num_tiles, dtype=torch.bool, device=dev)
        in_cells = 0
        for s in range(0, p.num_tiles, CHECK_TILES):
            cnt = p.counts(s, s + CHECK_TILES)
            cs = c[s : s + CHECK_TILES]
            check(
                not bool(((cs.view(torch.int16) != 0) & (cnt == 0)).any()),
                f"{part_name(p)}: a cell without an edge is not +0",
            )
            check(bool(torch.isfinite(cs.float()).all()), f"{part_name(p)}: non-finite cell")
            real[s : s + CHECK_TILES] = cnt.reshape(cnt.shape[0], -1).any(dim=1)
            in_cells += int(cnt.sum(dtype=torch.int64))
        check(in_cells == p.num_dense_edges, f"{part_name(p)}: cell counts do not sum to its dense edges")
        dense_edges += p.num_dense_edges
        tmap = torch.full((p.num_row_tiles, p.num_col_tiles), -1, dtype=torch.long, device=dev)
        idx = real.nonzero().squeeze(1)
        tmap[p.tile_row.long()[idx], p.tile_col.long()[idx]] = idx
        maps.append(tmap)
    check(dense_edges + agg.plan.num_edges == m, "dense edges + residual edges != m")

    g_dst, g_src = edge_lists(g, dev)
    in_tiles, bad = 0, 0
    for s in range(0, m, CHECK_EDGES):
        d, sr = g_dst[s : s + CHECK_EDGES], g_src[s : s + CHECK_EDGES]
        ref = (a64.index_select(0, sr) * b64.index_select(0, d)).sum(dim=1)
        hit_any = torch.zeros(d.shape[0], dtype=torch.bool, device=dev)
        for p, c, tmap in zip(parts, cells, maps):
            t = tmap[d // p.tile_rows, sr // p.tile_cols]
            hit = t >= 0
            th, i, j = t[hit], d[hit] % p.tile_rows, sr[hit] % p.tile_cols
            check(bool((cell_counts(p, th, i, j) > 0).all()), "an edge of a tile lies in a cell without an edge")
            bad += relative_error_count(c[th, i, j].float(), ref[hit])
            hit_any |= hit
        in_tiles += int(hit_any.sum())
    log(f"  dense edges vs f64 dots: gate_bad={bad} of {in_tiles} (edges in tiles; {dense_edges} in cell counts)")
    check(bad == 0, "dense edges fail the gate against the f64 dots")
    # edges outside every tile, and those past a cell's int8 cap, are the residual
    check(m - in_tiles + (in_tiles - dense_edges) == agg.plan.num_edges, "the residual is not the edges left outside the cells")

    residual_checks(agg.plan, res, a64, b64, "")


def residual_checks(plan, res, a64, b64, what: str):
    """Every residual slot of an SDDMM pass passes the gate against the
    float64 dot of its edge, and every pad slot is 0."""
    dev = a64.device
    bsz = plan.block_size
    valid = torch.arange(bsz, device=dev)[None, :] < plan.count.long()[:, None]
    valid = valid.reshape(-1)
    check(int(valid.sum()) == plan.num_edges, f"{what}residual slots != residual edges")
    check(bool((res[~valid] == 0).all()), f"{what}a residual pad slot is not 0")
    src, dst = plan.src_flat(), plan.dst.repeat_interleave(bsz)
    bad = 0
    for s in range(0, src.shape[0], CHECK_EDGES):
        v = valid[s : s + CHECK_EDGES]
        ref = (a64.index_select(0, src[s : s + CHECK_EDGES]) * b64.index_select(0, dst[s : s + CHECK_EDGES])).sum(dim=1)
        bad += relative_error_count(res[s : s + CHECK_EDGES][v], ref[v])
    log(f"  {what}residual edges vs f64 dots: gate_bad={bad} of {plan.num_edges}")
    check(bad == 0, f"{what}residual edges fail the gate against the f64 dots")


def sddmm_phases(args, g, gen) -> dict:
    """Phases 12-13: B6 against its plain version, then bench.py's SDDMM
    path.  Returns what phase 15 times."""
    dev = gen.device
    n, m = g.num_nodes, g.num_edges
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, bit_tiles=True, device=dev, **SDDMM_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    parts = agg.tile_parts()
    check(len(parts) == 2, "the SDDMM plan did not split into a 1-bit and an int8 part")
    parts16 = [host_plan(p).pad_runs(16).to(dev) for p in parts]
    nnz = [
        sum(int((p.counts(s, s + CHECK_TILES) > 0).sum()) for s in range(0, p.num_tiles, CHECK_TILES))
        for p in parts
    ]
    log(
        f"SDDMM plan ({args.scale}): " + "; ".join(
            f"{part_name(p)} part tiles={p.num_tiles} (pack16: {p16.num_tiles}) nonzero cells={z} "
            f"dense edges={p.num_dense_edges} A bytes={p.a.numel()} longest run={int(p.run_start.diff().max())}"
            for p, p16, z in zip(parts, parts16, nnz)
        )
        + f"; residual edges={agg.plan.num_edges} tasks={agg.plan.num_tasks}; cell bytes (bf16)="
        f"{sum(2 * p.num_tiles * p.tile_rows * p.tile_cols for p in parts)}; built in {build_s:.1f} s"
    )

    # ---- phase 12: B6 against its plain version
    log("phase 12: B6 kernel vs sddmm_bcsr_plain")
    max_err = 0.0
    with torch.no_grad():
        for plans, label in ((parts, "pack1"), (parts16, "pack16")):
            for p in plans:
                for f in BENCH_DIMS[1:]:
                    err = sddmm_vs_plain(p, f, gen, f"{label} {part_name(p)}")
                    if label == "pack1":
                        max_err = max(max_err, err)
        ng, _ = ragged_graph()
        rhost = densify(ng, dtype=np.int8, **SDDMM_SCHEDULE)[0]
        ragged = [rhost.pad_runs(16)] + [p.pad_runs(16) for p in split_bit_tiles(rhost) if p is not None]
        fillers = [filler_only_runs(p) for p in ragged]
        check(ng.num_nodes % SDDMM_SCHEDULE["tile_rows"] != 0 and all(fillers), "SDDMM ragged case lacks a filler-only run")
        log(f"  ragged raw-count plan: n={ng.num_nodes}, int8 / 1-bit / int8 parts tiles "
            f"{[p.num_tiles for p in ragged]}, filler-only runs {fillers}")
        for p in ragged:
            for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
                sddmm_vs_plain(p.to(dev), f, gen, f"ragged {'' if p is ragged[0] else 'part '}{part_name(p)}")
        odd, _ = split_bit_tiles(densify(ng, dtype=np.int8, tile_rows=200, tile_cols=128, threshold=24)[0])
        check(odd is not None, "no 1-bit part at R = 200")
        sddmm_vs_plain(odd.to(dev), SDDMM_F, gen, "1-bit R=200")
        for p in parts:
            sddmm_inf_non_edge(p, gen)
        del ragged, odd

    # ---- phase 13: the SDDMM path
    log(f"phase 13: bench.py --model sddmm path, {SDDMM_CALLS} hybrid_sddmm calls (split23, f16_split2)")
    a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
    b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
    plan = agg.plan if agg.plan.num_edges else None

    def path():
        return hybrid_sddmm(parts, plan, a, b, gather_dtype="f16_split2", dot_mode="split23")

    with torch.no_grad():
        reset_counts()
        for _ in range(SDDMM_CALLS):
            cells, res = path()
        torch.cuda.synchronize()
        launches = cuda_sddmm.launches
        log(f"  B6 launches in {SDDMM_CALLS} calls: {launches} ({len(parts)} parts)")
        check(launches == SDDMM_CALLS * len(parts), "B6 did not launch once per part per call")
        check(only("B6"), "the SDDMM path launched another kernel")
        sddmm_path_checks(g, agg, cells, res, a, b)
        del cells, res
    return dict(agg=agg, parts16=parts16, nnz=nnz, a=a, b=b, path=path, launches=launches, max_err=max_err)


def bits_gcn_phase(g, h0, tile_host, res_host, res_plan, gcn_out, forwards, gen) -> dict:
    """Phase 14: B1 over 1-bit tiles against its plain version, then the GCN
    forward over phase 3's plan split by split_bit_tiles.  Returns what
    phase 15 times."""
    dev = h0.device
    n = g.num_nodes
    tb, ti = split_bit_tiles(tile_host)
    check(tb is not None and ti is not None, "the GCN plan did not split into a 1-bit and an int8 part")
    tb, ti = tb.to(dev), ti.to(dev)
    agg = Aggregator(plan=res_plan, num_nodes=n, n_src=g.n_src, num_edges=g.num_edges, tile=ti, tile_bits=tb)
    log(
        f"phase 14: GCN forward over 1-bit tiles: phase 3's plan split into a 1-bit part (tiles={tb.num_tiles}, "
        f"dense edges={tb.num_dense_edges}, A bytes={tb.a.numel()}) and an int8 part (tiles={ti.num_tiles}, "
        f"dense edges={ti.num_dense_edges}, A bytes={ti.a.numel()}); unsplit A bytes={tile_host.a.nbytes}"
    )
    tb16 = host_plan(tb).pad_runs(16).to(dev)
    max_err = 0.0
    with torch.no_grad():
        for plan, label in ((tb, "1-bit pack1"), (tb16, "1-bit pack16")):
            for f in BENCH_DIMS[1:]:
                for mode in ("split", "native"):
                    err = kernel_vs_plain(plan, f, mode, gen, label)
                    if plan is tb:
                        max_err = max(max_err, err)
        ng, rng = ragged_graph()
        sd = rng.uniform(0.2, 2.0, ng.num_nodes).astype(np.float32)
        ss = rng.uniform(0.2, 2.0, ng.n_src).astype(np.float32)
        ragged, _ = densify(ng, dtype=np.int8, val=sd[ng.dst_per_edge] * ss[ng.indices], scale_dst=sd, scale_src=ss, **SCHEDULE)
        rbits = split_bit_tiles(ragged)[0].pad_runs(16)
        check(bool(filler_only_runs(rbits)), "1-bit ragged case lacks a filler-only run")
        rbits = rbits.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            for mode in ("split", "native"):
                kernel_vs_plain(rbits, f, mode, gen, "ragged factored 1-bit part")
        del rbits, ragged

        model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
        opts = fast_layer_opts(BENCH_DIMS)
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        log(f"  B1 launches in {forwards} forwards: {launches} (3 layers x 2 parts)")
        check(launches == 6 * forwards, "B1 did not launch 6 times per forward")
        check(only_with_r1("B1", forwards * residual_layers(agg, opts)),
              "the 1-bit GCN forward launched another kernel, or R1 not once a float32-row layer")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "1-bit forward output")
        tp = tile_host.to(dev)  # the unsplit plan: its cells are the two parts' cells
        edges = gcn_edges(g, res_host, tp)
        xs = gcn_gates(agg, model.weights, opts, h0, out, edges, "1-bit ")
        del edges
        bad = relative_error_count(out, gcn_out)
        log(f"  1-bit forward vs phase 3's int8 forward: gate_bad={bad} max|d|={(out - gcn_out).abs().max().item():.3e}")
        check(bad == 0, "the 1-bit forward differs from the int8 forward")
    return dict(agg=agg, model=model, opts=opts, xs=xs, tp=tp, launches=launches, max_err=max_err)


def timing_phase(g, sd, bt) -> tuple:
    """Phase 15: the SDDMM path and B6, then the 1-bit GCN forward and B1
    over 1-bit tiles.  Returns (B6 entry fields, B1 1-bit entry fields)."""
    log("phase 15: SDDMM and 1-bit timing (CUDA events, median of 10 after 3 warm-up)")
    n, m = g.num_nodes, g.num_edges
    agg, a, b = sd["agg"], sd["a"], sd["b"]
    with torch.no_grad():
        path_ms = cuda_time_ms(sd["path"])
        plan = agg.plan
        res_ms = cuda_time_ms(lambda: sddmm_slots(plan, a, b, gather_dtype="f16_split2")) if plan.num_edges else 0.0
        log(f"  SDDMM path: {path_ms:.3f} ms, {m / (path_ms / 1e3):.4e} edges/s; residual {res_ms:.3f} ms")
        at = a.t().contiguous()
        rows6 = []
        for p, p16, nnz in zip(agg.tile_parts(), sd["parts16"], sd["nnz"]):
            c_dst, c_src, _ = tile_cells(p)
            csr = cells_csr(c_dst, c_src, torch.ones(c_dst.shape[0], device=a.device), (n, p.n_src))
            lib = torch.sparse.sampled_addmm(csr, b, at, beta=0.0)
            r, c = csr_rows(lib), lib.col_indices()
            ref = (b.index_select(0, r) * a.index_select(0, c)).sum(dim=1)
            check((lib.values() - ref).abs().max() <= 1e-4 * ref.abs().max(), "sampled_addmm yardstick disagrees")
            t, f = p.num_tiles, SDDMM_F
            row = dict(
                part=part_name(p), f=f, tiles=t, tiles_pack16=p16.num_tiles, nnz_cells=nnz,
                ms=cuda_time_ms(lambda: cuda_sddmm.sddmm_bcsr_cuda(p, a, b)),
                ms_pack16=cuda_time_ms(lambda: cuda_sddmm.sddmm_bcsr_cuda(p16, a, b)),
                plain_ms=cuda_time_ms(lambda: sddmm_bcsr_plain(p, a, b)),
                library_ms=cuda_time_ms(lambda: torch.sparse.sampled_addmm(csr, b, at, beta=0.0)),
                **bound(p.a.numel() + 2 * t * p.tile_rows * p.tile_cols + 8 * t + 4 * f * (p.n_src + n), 2.0 * nnz * f),
            )
            rows6.append(row)
            log(
                f"  B6 {row['part']}: {row['ms']:.3f} ms/launch (pack16 {row['ms_pack16']:.3f}) bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}) | plain {row['plain_ms']:.3f} | "
                f"sampled_addmm {row['library_ms']:.3f}"
            )
            del csr, lib, ref

        bagg, model, opts, xs, tp = bt["agg"], bt["model"], bt["opts"], bt["xs"], bt["tp"]
        fwd_ms = cuda_time_ms(lambda: model(bagg, xs[0], opts))
        log(f"  1-bit GCN forward: {fwd_ms:.3f} ms")
        tb, ti = bagg.tile_bits, bagg.tile
        csr = tile_csr(tb)
        nnz = csr.values().numel()
        rows1 = []
        for i, w in enumerate(model.weights):
            x = round_h((xs[i] @ w).contiguous(), opts[i].tile_h_mode)
            f = x.shape[1]
            row = dict(
                f=f, tiles=tb.num_tiles, nnz_cells=nnz,
                ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tb, x)),
                int8_part_ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(ti, x)),
                unsplit_int8_ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x)),
                plain_ms=cuda_time_ms(lambda: bcsr_spmm_plain(tb, x)),
                library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, x)),
                **bound(tb.a.numel() + 4 * (tb.num_tiles + tb.num_row_tiles + 1) + 4 * f * (tb.n_src + n), 2.0 * nnz * f),
            )
            rows1.append(row)
            log(
                f"  layer {i + 1} f={f}: B1 1-bit part {row['ms']:.3f} ms/launch + int8 part {row['int8_part_ms']:.3f} "
                f"(unsplit int8 {row['unsplit_int8_ms']:.3f}) bound {row['bound_ms']:.4f} ({row['bound_by']}) | "
                f"plain {row['plain_ms']:.3f} | torch.sparse.mm {row['library_ms']:.3f}"
            )
    return (
        dict(rows=rows6, path_ms=path_ms, edges_per_s=m / (path_ms / 1e3), residual_ms=res_ms),
        dict(rows=rows1, forward_ms=fwd_ms),
    )


def bits_inf_non_edge(tp, tp_t, gen, what: str):
    """A non-edge (a zero cell of a 1-bit part, phase 16, or of a float plan,
    phase 29) whose unstabilized score overflows to inf: its row and its
    column hold edges in the same tile, so B2 scores the row and B3/B4 walk
    the row and the column; each must select on the cell, never multiply
    by it.  B2, B3 and B4 against their plain versions
    on the part, outputs finite."""
    r, c = tp.tile_rows, tp.tile_cols
    dev = tp.a.device
    found = None
    for t in range(tp.num_tiles):
        cnt = tp.counts(t, t + 1)[0]
        rows = tp.tile_row[t].long() * r + torch.arange(r, device=dev)
        cols = tp.tile_col[t].long() * c + torch.arange(c, device=dev)
        cand = (
            (cnt == 0) & (cnt.sum(1, keepdim=True) > 0) & (cnt.sum(0, keepdim=True) > 0)
            & (rows[:, None] != cols[None, :]) & (rows[:, None] < tp.num_nodes) & (cols[None, :] < tp.n_src)
        ).nonzero()
        if cand.shape[0]:
            found = (int(rows[cand[0, 0]]), int(cols[cand[0, 1]]))
            break
    check(found is not None, f"{what}: no non-edge whose row and column hold edges")
    row, col = found
    n = tp.num_nodes
    att = torch.zeros((n, 2), device=dev)
    att[row, 0] = 50.0
    att[col, 1] = 50.0  # exp(50 + 50) overflows float32
    dm, asrc = _score_terms(att)
    check(bool(torch.isinf(torch.exp(att[row, 0] + att[col, 1]))), f"{what}: the chosen non-edge's score is finite")
    h, gbar = (torch.randn((n, 16), generator=gen, device=dev) for _ in range(2))
    c_ = torch.randn(n, generator=gen, device=dev)
    num, den = gat_bcsr(tp, h, att)
    ref_num, ref_den = gat_bcsr_plain(tp, h, att)
    args = (h, gbar, c_, dm, asrc, DEFAULT_SLOPE)
    dad, (dh, das) = gat_bwd_dad(tp, *args), gat_bwd_dh_das(tp_t, *args)
    want_dad, (want_dh, want_das) = gat_bwd_dad_plain(tp, *args), gat_bwd_dh_das_plain(tp_t, *args)
    torch.cuda.synchronize()
    for got, want, out, gate in ((num, ref_num, "B2 num", False), (den, ref_den, "B2 den", True),
                                 (dad, want_dad, "B3 d_ad", False), (dh, want_dh, "B4 dh", False),
                                 (das, want_das, "B4 d_as", False)):
        compare(got, want, f"{what} non-edge ({row}, {col}) with an inf score: {out}", gate=gate)


def bits_kernel_phase(tb, tb_t, tb16, tb_t16, gat_bits, gat_bits16, gen) -> dict:
    """Phase 16: B2, B3, B4, B1 and B5 over 1-bit tiles against their plain
    versions.  Returns max|d| per kernel over the pack-1 training part."""
    dev = gen.device
    log("phase 16: B2, B3, B4, B1 and B5 over 1-bit tiles vs their plain versions")
    max_err = {"B3": 0.0, "B1_t": 0.0, "B2": 0.0}
    with torch.no_grad():
        for (p, p_t), label in (((tb, tb_t), "1-bit pack1"), ((tb16, tb_t16), "1-bit pack16")):
            for f in BENCH_DIMS[1:]:
                errs = (
                    bwd_kernels_vs_plain(p, p_t, f, gen, label),
                    kernel_vs_plain(p_t, f, "native", gen, f"{label} transposed"),
                    gat_kernel_vs_plain(p, f, gen, f"{label} [256, 256]"),
                )
                if p is tb:
                    for k, e in zip(("B3", "B1_t", "B2"), errs):
                        max_err[k] = max(max_err[k], e)
        for p, label in ((gat_bits, "GAT plan 1-bit pack1"), (gat_bits16, "GAT plan 1-bit pack16")):
            for f in BENCH_DIMS[1:]:
                gat_kernel_vs_plain(p, f, gen, label)
        ng, _ = ragged_graph()
        rbits = split_bit_tiles(densify(ng, dtype=np.int8, **TRAIN_SCHEDULE)[0])[0]
        ragged, ragged_t = rbits.pad_runs(16), rbits.transpose().pad_runs(16)
        fillers, fillers_t = filler_only_runs(ragged), filler_only_runs(ragged_t)
        check(bool(fillers) and bool(fillers_t), "1-bit training ragged case lacks a filler-only run")
        log(
            f"  ragged raw-count plan's 1-bit part: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only "
            f"runs={fillers}; transposed tiles={ragged_t.num_tiles} filler-only runs={fillers_t}"
        )
        ragged, ragged_t = ragged.to(dev), ragged_t.to(dev)
        for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
            bwd_kernels_vs_plain(ragged, ragged_t, f, gen, "ragged 1-bit")
            kernel_vs_plain(ragged_t, f, "native", gen, "ragged 1-bit transposed")
            gat_kernel_vs_plain(ragged, f, gen, "ragged 1-bit")
        odd, _ = split_bit_tiles(densify(ng, dtype=np.int8, tile_rows=200, tile_cols=128, threshold=24)[0])
        check(odd is not None, "no 1-bit part at R = 200")
        odd_t = odd.transpose()
        odd, odd_t = odd.to(dev), odd_t.to(dev)
        log(f"  1-bit part at R = 200: tiles={odd.num_tiles}; transposed [128, 200] tiles={odd_t.num_tiles}")
        bwd_kernels_vs_plain(odd, odd_t, BENCH_DIMS[1], gen, "1-bit R=200")
        kernel_vs_plain(odd_t, BENCH_DIMS[1], "native", gen, "1-bit R=200 transposed")
        gat_kernel_vs_plain(odd, BENCH_DIMS[1], gen, "1-bit R=200")
        bits_inf_non_edge(tb, tb_t, gen, "1-bit")
        del ragged, ragged_t, odd, odd_t
    return max_err


def bits_train_phases(args, g, h0, gen, train: dict, gat_out: dict, forwards: int) -> dict:
    """Phases 16-20: the 1-bit kernels of bit-tile training against their
    plain versions, GCN and GAT training over bench.py --train's default
    plan (1-bit and int8 parts with their transposes), the 1-bit GAT
    forward, and their timing.  Returns what the report needs."""
    dev = h0.device
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=1, with_transpose=True, bit_tiles=True, device=dev, **TRAIN_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    tb, ti, tb_t, ti_t = agg.tile_bits, agg.tile, agg.tile_bits_t, agg.tile_t
    check(None not in (tb, ti, tb_t, ti_t), "the training plan did not split into a 1-bit and an int8 part")
    hb, hi = split_bit_tiles(densify(g, dtype=np.int8, **TRAIN_SCHEDULE)[0])
    tb16, ti16 = hb.pad_runs(16).to(dev), hi.pad_runs(16).to(dev)
    tb_t16, ti_t16 = hb.transpose().pad_runs(16).to(dev), hi.transpose().pad_runs(16).to(dev)
    del hb, hi
    log(
        f"bit-tile training plan ({args.scale}): " + "; ".join(
            f"{part_name(p)} part tiles={p.num_tiles} (transposed {q.num_tiles}) dense edges={p.num_dense_edges} "
            f"A bytes={p.a.numel()} (transposed {q.a.numel()}) "
            f"longest run={int(p.run_start.diff().max())} (transposed {int(q.run_start.diff().max())})"
            for p, q in ((tb, tb_t), (ti, ti_t))
        ) + f"; built with both transposes in {build_s:.1f} s"
    )
    gagg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, bit_tiles=True, device=dev,
                                      **GAT_SCHEDULE)
    gat_bits = gagg.tile_bits
    check(gat_bits is not None and gagg.tile is not None, "the GAT plan did not split into a 1-bit and an int8 part")
    gat_bits16 = host_plan(gat_bits).pad_runs(16).to(dev)
    log(f"GAT plan split: 1-bit part tiles={gat_bits.num_tiles} (A bytes {gat_bits.a.numel()}), "
        f"int8 part tiles={gagg.tile.num_tiles} (A bytes {gagg.tile.a.numel()})")

    # ---- phase 16: the 1-bit kernels against their plain versions
    max_err = bits_kernel_phase(tb, tb_t, tb16, tb_t16, gat_bits, gat_bits16, gen)

    # ---- phase 17: GCN bit-tile training
    log(f"phase 17: GCN bit-tile training, {TRAIN_STEPS} steps of make_train_step (exact modes, Adam 1e-3)")
    gcn = gcn_training(agg, g, h0, "1-bit ")
    check(gcn["counts"]["B1"] == 12 * TRAIN_STEPS and gcn["bit_counts"]["B1"] == 6 * TRAIN_STEPS,
          "GCN bit-tile training: B1 did not launch 12 times per step, 6 of them 1-bit")
    check(all(v == 0 for k, v in gcn["counts"].items() if k not in ("B1", "R1")),
          "GCN bit-tile training launched a GAT kernel")
    for i, (got, want) in enumerate(zip(gcn["grads0"], train["gcn_grads0"])):
        r = rel_l2(got, want.double())
        log(f"  first step's w{i + 1} gradient vs phase 9's (int8 tiles): relative L2 {r:.3e}")
        check(r <= BITS_REL_L2, f"GCN bit-tile w{i + 1} gradient off the int8 step's")

    # ---- phase 18: GAT bit-tile training
    log(f"phase 18: GAT bit-tile training, {TRAIN_STEPS} steps (fast=False, stabilize='bound', dot_mode='split2')")
    gat = gat_training(agg, g, h0, "1-bit ")
    for k in ("B2", "B3", "B4"):
        check(gat["counts"][k] == 6 * TRAIN_STEPS and gat["bit_counts"][k] == 3 * TRAIN_STEPS,
              f"GAT bit-tile training: {k} did not launch 6 times per step, 3 of them 1-bit")
    check(gat["counts"]["B1"] == 0 and gat["counts"]["B5"] == 0, "GAT bit-tile training launched B1 or B5")
    for i, ((gw, ga), (ww, wa)) in enumerate(zip(gat["grads0"], train["gat_grads0"])):
        rw, ra = rel_l2(gw, ww.double()), rel_l2(ga, wa.double())
        log(f"  first step's layer {i + 1} gradient vs phase 10's (int8 tiles): w {rw:.3e}, w_att {ra:.3e}")
        check(rw <= BITS_REL_L2 and ra <= BITS_REL_L2, f"GAT bit-tile layer {i + 1} gradient off the int8 step's")

    # ---- phase 19: the 1-bit GAT forward
    log("phase 19: 3-layer GAT forward over phase 6's plan split by split_bit_tiles (fast=True, split2)")
    model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    params = model.layer_params()

    def fwd(**kw):
        return model(gagg, h0, fast=True, dot_mode="split2", **kw)

    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = fwd()
        torch.cuda.synchronize()
        fwd_counts = (cuda_gat.launches, cuda_gat.bits_launches)
        log(f"  B2 launches in {forwards} forwards: {fwd_counts[0]} ({fwd_counts[1]} 1-bit)")
        check(fwd_counts == (6 * forwards, 3 * forwards), "1-bit GAT forward: B2 not 6 launches a forward, 3 1-bit")
        check(only("B2"), "the 1-bit GAT forward launched another kernel")
        reset_counts()
        out_exact = fwd(stabilize=True)
        torch.cuda.synchronize()
        stab_counts = (cuda_rowmax.launches, cuda_rowmax.bits_launches, cuda_gat.launches)
        log(f"  stabilize=True forward: B5 launches {stab_counts[0]} ({stab_counts[1]} 1-bit), B2 {stab_counts[2]}")
        check(stab_counts == (6, 3, 6), "1-bit stabilized forward: B5 not 6 launches (3 1-bit) or B2 not 6")
        for label, o, want in (("un-stabilized", out, gat_out["out"]), ("stabilize=True", out_exact, gat_out["out_exact"])):
            bad = relative_error_count(o, want)
            log(f"  1-bit {label} forward vs phase 6's int8 one: gate_bad={bad} max|d|={(o - want).abs().max().item():.3e}")
            check(o.shape == want.shape and bool(torch.isfinite(o).all()) and bad == 0,
                  f"the 1-bit {label} GAT forward differs from the int8 one")
        xs = [h0]
        for p in params:
            xs.append(gat_forward(gagg, [p], xs[-1], fast=True, dot_mode="split2"))

    # ---- phase 20: timing
    log("phase 20: bit-tile timing (CUDA events, median of 10 after 3 warm-up)")
    times = step_times(gcn, gat, h0)
    for k, v in train["times"].items():
        log(f"  {k}: 1-bit {times[k]:.3f} ms vs int8 {v:.3f} ms (phase 11)")
    with torch.no_grad():
        fwd_ms = cuda_time_ms(fwd)
        stab_ms = cuda_time_ms(lambda: fwd(stabilize=True))
        log(f"  1-bit GAT forward: {fwd_ms:.3f} ms; stabilize=True {stab_ms:.3f} ms")
        log("  training kernels over the 1-bit part:")
        rows_b = train_kernel_times(tb, tb_t, tb16, tb_t16, gen)
        log("  training kernels over the int8 part:")
        rows_i = train_kernel_times(ti, ti_t, ti16, ti_t16, gen)
        rows5 = b5_rows(gat_bits, gat_bits16, xs, params)
        rows5_i = b5_rows(gagg.tile, host_plan(gagg.tile).pad_runs(16).to(dev), xs, params)
    return dict(
        build_s=build_s, max_err=max_err, times=times, gcn_counts=gcn["counts"], gcn_bits=gcn["bit_counts"],
        gat_counts=gat["counts"], gat_bits=gat["bit_counts"], gcn_losses=gcn["losses"], gat_losses=gat["losses"],
        fwd_counts=fwd_counts, stab_counts=stab_counts, forward_ms=fwd_ms, stab_ms=stab_ms,
        rows_b=rows_b, rows_i=rows_i, rows5=rows5, rows5_i=rows5_i,
    )


def bits_train_reddit_phase(g, h0) -> dict:
    """--scale reddit: bench.py --train's headline configuration at its own
    scale, GCN only (the float64 oracles of phases 9 and 17 hold the whole
    edge list): the [256, 256] t24 bit-tile plan with its transposes, the
    first step's weight gradients against the same step over the same parts
    passed through unpack_bits() (a check, not the training path), then
    REDDIT_STEPS steps with B1 at 12 launches a step, and the step's time."""
    dev = h0.device
    n = g.num_nodes
    log(f"phase 17 (reddit): GCN bit-tile training, {REDDIT_STEPS} steps")
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=1, with_transpose=True, bit_tiles=True, device=dev, **TRAIN_SCHEDULE
    )
    build_s = time.perf_counter() - t0
    log(
        "  plan: " + "; ".join(
            f"{part_name(p)} part tiles={p.num_tiles} (transposed {q.num_tiles}) A bytes={p.a.numel()}"
            for p, q in ((agg.tile_bits, agg.tile_bits_t), (agg.tile, agg.tile_t))
        ) + f"; residual edges={agg.plan.num_edges}; built with both transposes in {build_s:.1f} s"
    )
    labels = train_labels(n, dev)
    unpacked = dataclasses.replace(
        agg, tile_bits=agg.tile_bits.unpack_bits(), tile_bits_t=agg.tile_bits_t.unpack_bits()
    )
    grads = []
    for a in (unpacked, agg):
        gcn = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
        softmax_xent(gcn(a, h0), labels).backward()
        grads.append([w.grad.detach().clone() for w in gcn.weights])
    del unpacked
    torch.cuda.empty_cache()
    for i, (got, want) in enumerate(zip(grads[1], grads[0])):
        r = rel_l2(got, want.double())
        log(f"  first step's w{i + 1} gradient vs the unpacked parts': relative L2 {r:.3e}")
        check(r <= BITS_REL_L2, f"reddit bit-tile w{i + 1} gradient off the unpacked parts' step")
    gcn.zero_grad(set_to_none=True)
    step = make_train_step(lambda h: gcn(agg, h), torch.optim.Adam(gcn.parameters(), lr=1e-3), device=dev)
    reset_counts()
    losses = [step((h0,), labels) for _ in range(REDDIT_STEPS)]
    torch.cuda.synchronize()
    c, cb = counts(), bit_counts()
    losses = [float(v) for v in losses]
    log(f"  losses {losses}; launches in {REDDIT_STEPS} steps: B1 {c['B1']} ({cb['B1']} 1-bit)")
    check(all(np.isfinite(losses)), "reddit bit-tile GCN training loss not finite")
    check(c["B1"] == 12 * REDDIT_STEPS and cb["B1"] == 6 * REDDIT_STEPS
          and only_with_r1("B1", 2 * REDDIT_STEPS * residual_layers(agg)),
          "reddit bit-tile GCN training: B1 not 12 launches a step (6 1-bit), R1 not 6, or another kernel launched")
    step_ms = cuda_time_ms(lambda: step((h0,), labels))
    with torch.no_grad():
        forward_ms = cuda_time_ms(lambda: gcn(agg, h0))
    log(f"  GCN bit-tile step {step_ms:.3f} ms = forward {forward_ms:.3f} + backward and Adam {step_ms - forward_ms:.3f}")
    return dict(
        path=f"GCN bit-tile training step at reddit scale, {REDDIT_STEPS} steps", launches=c["B1"],
        bits_launches=cb["B1"], launches_per_step=12, step_ms=step_ms, forward_ms=forward_ms,
        backward_adam_ms=step_ms - forward_ms, plan_build_s=build_s, losses=losses,
    )


def float_kernel_rows(tp, xs_or_h, what: str, tp16=None) -> list:
    """B1 timing rows over one plan, one row per operand in ``xs_or_h``
    (f = 128, 64, 32): ms a launch (and pack 16), the plain version, the
    torch.sparse.mm yardstick over the cells' CSR (built outside the timed
    call) and the bound: A's bytes (1, 2 or 4 a cell; R*C/8 a 1-bit tile),
    H read and the output written once, 2 FLOPs a nonzero cell and f."""
    csr = tile_csr(tp)
    nnz = csr.values().numel()
    a_bytes = tp.a.numel() * tp.a.element_size()
    rows = []
    for x in xs_or_h:
        f = x.shape[1]
        row = dict(
            f=f, ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x)),
            plain_ms=cuda_time_ms(lambda: bcsr_spmm_plain(tp, x)),
            library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, x)), tiles=tp.num_tiles, nnz_cells=nnz,
            a_bytes=a_bytes,
            **bound(a_bytes + 4 * (tp.num_tiles + tp.num_row_tiles + 1) + 4 * f * (tp.n_src + tp.num_nodes),
                    2.0 * nnz * f),
        )
        if tp16 is not None:
            row["ms_pack16"] = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp16, x))
        rows.append(row)
        log(
            f"  {what} f={f}: B1 {row['ms']:.3f} ms/launch"
            + (f" (pack16 {row['ms_pack16']:.3f})" if tp16 is not None else "")
            + f" bound {row['bound_ms']:.4f} ({row['bound_by']}) | plain {row['plain_ms']:.3f} | "
            f"torch.sparse.mm {row['library_ms']:.3f}"
        )
    del csr
    return rows


def epilogue_vs_plain(tp, f: int, f_out: int, gen, what: str) -> float:
    """B1's w_epilogue variant against bcsr_spmm_nn_plain on signed N(0, 1)
    h and W = 0.1 N(0, 1): agg and trans each within KERNEL_TOL *
    max|plain|.  Returns max|d| of both, relative to their max|plain|."""
    h = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    w = torch.randn((f, f_out), generator=gen, device="cuda") * 0.1
    agg, trans = bcsr_spmm_nn(tp, h, w)
    want_agg, want_trans = bcsr_spmm_nn_plain(tp, h, w)
    torch.cuda.synchronize()
    e1 = compare(agg, want_agg, f"{what} ({f}, {f_out}) agg", gate=False)
    e2 = compare(trans, want_trans, f"{what} ({f}, {f_out}) trans", gate=False)
    return max(e1, e2)


def float_phases(g, h0, gen, gcn_out, forwards) -> dict:
    """Phases 22-27 (quick scale): B1 over float32 / bfloat16 tiles and its
    w_epilogue against their plain versions, then the four paths of float
    tiles and the fused aggregate+GEMM, and their timing.  Returns the
    kernels line's B1 entries."""
    dev = h0.device
    n = g.num_nodes
    val = g.gcn_norm_val()
    t0 = time.perf_counter()
    # the JAX package's defaults: float32 tiles of the edge values, with
    # the transposed plans
    agg = Aggregator.schedule_hybrid(g, val=val, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE)
    build_s = time.perf_counter() - t0
    tile_host, res_host = densify(g, val=val, **SCHEDULE)
    tp, tp_t = agg.tile, agg.tile_t
    check(tp.format == "float32" and tp_t.format == "float32", "the weighted schedule's tiles are not float32")
    tile16, tile_t16 = tile_host.pad_runs(16).to(dev), tile_host.transpose().pad_runs(16).to(dev)
    del tile_host
    bf, bf_t, bf16p, bf_t16 = (p.astype(torch.bfloat16) for p in (tp, tp_t, tile16, tile_t16))
    log(
        f"weighted GCN plan (gcn_norm_val, float32 tiles): tiles={tp.num_tiles} (pack16: {tile16.num_tiles}) "
        f"transposed {tp_t.num_tiles}; A bytes={tp.a.numel() * 4} (bf16 {bf.a.numel() * 2}); "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges}; built in {build_s:.1f} s"
    )
    fused = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                       pack=1, device=dev, **FUSED_SCHEDULE)
    fused_bits = split_bit_tiles(densify(g, dtype=np.int8, **FUSED_SCHEDULE)[0])[0].to(dev)
    gnorm = densify_gcn_norm(g, **SCHEDULE)[0].to(dev)

    # ---- phase 22: B1 over float A and the epilogue against their plain versions
    log("phase 22: B1 over float32 / bfloat16 A and B1's w_epilogue vs their plain versions")
    max_err = {"f32": 0.0, "bf16": 0.0, "epilogue": 0.0}
    with torch.no_grad():
        for (p1, p16), label, key in (
            ((tp, tile16), "f32", "f32"), ((tp_t, tile_t16), "f32 transposed", "f32"),
            ((bf, bf16p), "bf16", "bf16"), ((bf_t, bf_t16), "bf16 transposed", "bf16"),
        ):
            for plan, pk in ((p1, "pack1"), (p16, "pack16")):
                for f in BENCH_DIMS[1:]:
                    err = kernel_vs_plain(plan, f, "native", gen, f"{label} {pk}")
                    if pk == "pack1":
                        max_err[key] = max(max_err[key], err)
        for f in BENCH_DIMS[1:]:
            for mode in ("split", "native"):
                kernel_vs_plain(gnorm, f, mode, gen, "densify_gcn_norm (f32 counts, scales)")
        ng, rng = ragged_graph()
        rhost = densify(ng, val=rng.uniform(0.2, 2.0, ng.num_edges).astype(np.float32), **SCHEDULE)[0].pad_runs(16)
        check(bool(filler_only_runs(rhost)), "float ragged case lacks a filler-only run")
        for fmt in (np.float32, torch.bfloat16):
            rp = rhost.astype(fmt).to(dev)
            for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
                kernel_vs_plain(rp, f, "native", gen, f"ragged {rp.format}")
        del rhost, rp
        for part, label in ((fused.tile, "epilogue int8"), (fused_bits, "epilogue 1-bit"), (tp, "epilogue f32"),
                            (bf, "epilogue bf16"), (gnorm, "epilogue factored f32")):
            for f, f_out in EPILOGUE_SHAPES:
                max_err["epilogue"] = max(max_err["epilogue"], epilogue_vs_plain(part, f, f_out, gen, label))

    # ---- phase 23: path 1, the weighted GCN forward over float32 tiles
    log("phase 23: weighted 3-layer GCN forward over float32 tiles (gcn_norm_val), fast_layer_opts")
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    opts = fast_layer_opts(BENCH_DIMS)
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        fwd_counts = (cuda_bcsr.launches, cuda_bcsr.float_launches)
        log(f"  B1 launches in {forwards} forwards: {fwd_counts[0]}, float32 tiles: {fwd_counts[1]}")
        check(only_with_r1("B1", forwards * residual_layers(agg, opts)) and fwd_counts == (3 * forwards, 3 * forwards),
              "the weighted forward: B1 not 3 float launches a forward, or R1 not once a float32-row layer")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "weighted forward output")
        edges = gcn_edges(g, res_host, tp, val)
        xs = gcn_gates(agg, model.weights, opts, h0, out, edges, "weighted ")
        del edges

    # ---- phase 24: path 1, weighted GCN training over float32 tiles and their transpose
    log(f"phase 24: weighted GCN training over float32 tiles, {TRAIN_STEPS} steps (exact modes, Adam 1e-3)")
    gcn = gcn_training(agg, g, h0, "weighted ", val=val)
    check(gcn["counts"]["B1"] == 6 * TRAIN_STEPS and only_with_r1("B1", 2 * TRAIN_STEPS * residual_layers(agg)),
          "weighted GCN training: B1 not 6 launches a step, or R1 not 6")
    check(cuda_bcsr.float_launches == 6 * TRAIN_STEPS, "weighted GCN training: B1 not over float tiles")
    train_float = cuda_bcsr.float_launches

    # ---- phase 25: path 2, bench.py --tile-dtype bf16
    log("phase 25: bench.py --tile-dtype bf16: phase 3's GCN forward over bfloat16 count tiles")
    agg2 = Aggregator.schedule_hybrid(g, tile_dtype=torch.bfloat16, with_transpose=False,
                                      residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE)
    check(agg2.tile.format == "bfloat16", "bench.py --tile-dtype bf16 did not build bfloat16 tiles")
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out2 = model(agg2, h0, opts)
        torch.cuda.synchronize()
        bf16_counts = (cuda_bcsr.launches, cuda_bcsr.float_launches)
        check(only_with_r1("B1", forwards * residual_layers(agg2, opts)) and bf16_counts == (3 * forwards, 3 * forwards),
              "the bf16 forward: B1 not 3 float launches, or R1 not once a float32-row layer")
        # bfloat16 holds counts up to 256 exactly; int8 tiles cap a cell at
        # 127 and spill the rest to the residual, bfloat16 tiles keep every
        # edge and round an odd count above 256 (as the JAX package's do)
        vals = agg2.tile.a.float()
        rounded = int((vals > 256).sum())
        del vals
        bad = relative_error_count(out2, gcn_out)
        log(f"  B1 launches {bf16_counts}; cells above 256: {rounded}; vs phase 3's int8 forward: gate_bad={bad} "
            f"of {out2.numel()} max|d|={(out2 - gcn_out).abs().max().item():.3e}")
        check(bad <= PURE_BAD_FRACTION * out2.numel(), "the bfloat16-tile forward is off the int8 forward")

    # ---- phase 26: path 3, the updateval chain (B6 -> B1 over float32 tiles)
    log("phase 26: updateval chain: hybrid_sddmm cells -> tileplan_with_values -> B1 over float32 tiles")
    sagg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                      pack=1, bit_tiles=True, device=dev, **SDDMM_SCHEDULE)
    parts = sagg.tile_parts()
    a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
    b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
    hc = torch.from_numpy(normal_features(n, SDDMM_F, seed=5)).to(dev)

    def chain():
        cells, _ = hybrid_sddmm(parts, None, a, b, out_dtype=torch.float32, dot_mode="split23")
        wparts = [tileplan_with_values(p, c) for p, c in zip(parts, cells)]
        return bcsr_spmm(wparts, hc), wparts

    with torch.no_grad():
        reset_counts()
        out3, wparts = chain()
        torch.cuda.synchronize()
        chain_counts = counts()
        log(f"  launches: {chain_counts}, B1 float32 tiles {cuda_bcsr.float_launches}")
        check(chain_counts["B6"] == len(parts) and chain_counts["B1"] == len(parts)
              and cuda_bcsr.float_launches == len(parts), "the updateval chain did not run B6 then B1 over float tiles")
        a64, b64 = a.double(), b.double()
        ref3 = torch.zeros((n, SDDMM_F), dtype=torch.float64, device=dev)
        for p in parts:
            c_dst, c_src, c_cnt = tile_cells(p)
            wgt = c_cnt * (b64.index_select(0, c_dst) * a64.index_select(0, c_src)).sum(dim=1)
            ref3 += edge_sum(hc.double(), c_dst, c_src, wgt)
        bad = relative_error_count(out3, ref3)
        log(f"  (S * A_dense) @ h vs f64 oracle: gate_bad={bad} of {ref3.numel()}")
        check(bad == 0, "the updateval chain fails the gate against the f64 (S * A_dense) @ h")
        del ref3, a64, b64

    # ---- phase 27: path 4, the fused aggregate+GEMM (fig10b_pallas)
    log(f"phase 27: hybrid_spmm_nn over fig10b_pallas's schedule, f={FUSED_F}, {FUSED_CALLS} calls")
    hx = torch.from_numpy(normal_features(n, FUSED_F, seed=1)).to(dev)
    wx = torch.from_numpy(normal_features(FUSED_F, FUSED_F, seed=3) * 0.1).to(dev)
    fparts = fused.tile_parts()
    with torch.no_grad():
        reset_counts()
        for _ in range(FUSED_CALLS):
            fa, ft = hybrid_spmm_nn(fused, hx, wx)
        torch.cuda.synchronize()
        fused_counts = (cuda_bcsr.launches, cuda_bcsr.epilogue_launches)
        log(f"  B1 launches {fused_counts[0]}, w_epilogue {fused_counts[1]} ({len(fparts)} part(s) a call)")
        check(only("B1") and fused_counts == (len(fparts) * FUSED_CALLS,) * 2,
              "the fused path did not launch the w_epilogue kernel once a part a call")
        g_dst, g_src = edge_lists(g, dev)
        agg64 = edge_sum(hx.double(), g_dst, g_src)
        for got, want, what in ((fa, agg64, "agg"), (ft, agg64 @ wx.double(), "trans")):
            bad = relative_error_count(got, want)
            log(f"  fused {what} vs f64 oracle: gate_bad={bad} of {want.numel()}")
            check(bad == 0, f"the fused {what} fails the gate against the f64 oracle")
        del agg64, g_dst, g_src

    # ---- timing
    log("phase 27 timing: float tiles and the fused path (CUDA events, median of 10 after 3 warm-up)")
    with torch.no_grad():
        times = dict(
            weighted_forward_ms=cuda_time_ms(lambda: model(agg, h0, opts)),
            bf16_forward_ms=cuda_time_ms(lambda: model(agg2, h0, opts)),
            chain_ms=cuda_time_ms(lambda: chain()[0]),
            fused_ms=cuda_time_ms(lambda: hybrid_spmm_nn(fused, hx, wx)),
            split_ms=cuda_time_ms(lambda: fused.run(hx) @ wx),
        )
    times["weighted_step_ms"] = cuda_time_ms(gcn["step"])
    log(
        f"  weighted GCN forward {times['weighted_forward_ms']:.3f} ms, step {times['weighted_step_ms']:.3f} ms; "
        f"bf16-tile forward {times['bf16_forward_ms']:.3f} ms; updateval chain {times['chain_ms']:.3f} ms; "
        f"fused {times['fused_ms']:.3f} ms vs split (B1 + residual, then matmul) {times['split_ms']:.3f} ms"
    )
    with torch.no_grad():
        zs = [(xs[i] @ w).contiguous() for i, w in enumerate(model.weights)]
        rows_f32 = float_kernel_rows(tp, zs, "f32 [512, 256] t48", tile16)
        rows_bf16 = float_kernel_rows(agg2.tile, [round_h(z, "split").contiguous() for z in zs], "bf16 counts")
        cts = [cotangent((n, z.shape[1]), dev).float() for z in zs]
        rows_t = float_kernel_rows(tp_t, cts, "f32 transposed", tile_t16)
        rows_chain = [float_kernel_rows(w, [hc], f"updateval {part_name(p)} part")[0] for w, p in zip(wparts, parts)]
        rows_epi = []
        for part in fparts:
            csr = tile_csr(part)
            nnz = csr.values().numel()
            a_bytes = part.a.numel() * part.a.element_size()
            f, f_out = FUSED_F, FUSED_F
            row = dict(
                f=f, f_out=f_out, ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_nn_cuda(part, hx, wx)),
                plain_ms=cuda_time_ms(lambda: bcsr_spmm_nn_plain(part, hx, wx)),
                library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, hx) @ wx),
                split_kernel_ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(part, hx) @ wx),
                tiles=part.num_tiles, nnz_cells=nnz,
                **bound(a_bytes + 4 * (part.num_tiles + part.num_row_tiles + 1) + 4 * f * part.n_src
                        + 4 * (f + f_out) * part.num_nodes + 4 * f * f_out,
                        2.0 * nnz * f + 2.0 * part.num_nodes * f * f_out),
            )
            rows_epi.append(row)
            log(
                f"  epilogue {part_name(part)} part f={f} f_out={f_out}: {row['ms']:.3f} ms/launch, B1 then matmul "
                f"{row['split_kernel_ms']:.3f} | bound {row['bound_ms']:.4f} ({row['bound_by']}) | plain "
                f"{row['plain_ms']:.3f} | torch.sparse.mm + matmul {row['library_ms']:.3f}"
            )
            del csr
    return dict(
        max_err=max_err, times=times, rows_f32=rows_f32, rows_bf16=rows_bf16, rows_t=rows_t, rows_chain=rows_chain,
        rows_epi=rows_epi, fwd_counts=fwd_counts, bf16_counts=bf16_counts, train_counts=gcn["counts"],
        train_float=train_float, train_losses=gcn["losses"], chain_counts=chain_counts, fused_counts=fused_counts,
        build_s=build_s,
    )


def softmax_oracle(g_dst, g_src, n, h, att, slope=DEFAULT_SLOPE):
    """float64 GAT aggregation over an edge list with autograd: per row the
    softmax of lrelu(ad_i + as_j) over its in-edges, shifted by the row's
    max logit (so exp never overflows).  Returns (out, h64, att64)."""
    h64 = h.detach().double().requires_grad_(True)
    a64 = att.detach().double().requires_grad_(True)
    z = a64[g_dst, 0] + a64[g_src, 1]
    lz = torch.maximum(z, slope * z)
    mx = torch.full((n,), -torch.inf, dtype=torch.float64, device=h.device).scatter_reduce(0, g_dst, lz, "amax")
    s = torch.exp(lz - mx[g_dst].detach())
    den = torch.zeros(n, dtype=torch.float64, device=h.device).index_add(0, g_dst, s)
    num = torch.zeros((n, h.shape[1]), dtype=torch.float64, device=h.device).index_add(
        0, g_dst, s[:, None] * h64.index_select(0, g_src)
    )
    return num / torch.where(den == 0, 1.0, den)[:, None], h64, a64


def wide_logit_check(agg, g, h, att, stabilize, what: str):
    """hybrid_gat forward and gradients over ``agg`` on the card: finite and
    within the gate of float64 autograd of the softmax oracle (cotangent
    cos(arange)), with the gate's absolute floor at 1e-5 * max|ref|: d_ad
    and d_as are signed sums that cancel (d_ad_i is exactly 0 when all of
    row i's edges lie on one branch of leaky-relu), where two summation
    orders differ by more than the gate's 1e-5."""
    dev = h.device
    g_dst, g_src = edge_lists(g, dev)
    ct = cotangent(tuple(h.shape), dev)
    want, h64, a64 = softmax_oracle(g_dst, g_src, g.num_nodes, h, att)
    (want * ct).sum().backward()
    hg, ag = h.clone().requires_grad_(True), att.clone().requires_grad_(True)
    out = agg.run_gat(hg, ag, stabilize=stabilize)
    (out * ct.float()).sum().backward()
    torch.cuda.synchronize()
    for got, ref, name in ((out, want, "out"), (hg.grad, h64.grad, "dh"), (ag.grad, a64.grad, "datt")):
        check(bool(torch.isfinite(got).all()), f"{what} {name}: non-finite")
        scale = ref.abs().max().item()
        bad = relative_error_count(got.detach(), ref.detach(), 1e-2, max(1e-5, KERNEL_TOL * scale))
        err = (got.detach().double() - ref.detach()).abs().max().item()
        log(f"  {what} stabilize={stabilize!r} {name} vs f64 softmax: gate_bad={bad} of {ref.numel()} "
            f"max|d|={err:.3e} max|ref|={scale:.3e}")
        check(bad == 0, f"{what} stabilize={stabilize!r} {name} off the float64 softmax")


def repair_phase(g, gen) -> dict:
    """Phase 28: the repairs on the card.  C1: one source's as at 95 and 120
    on the 16x16 case and on the GAT plan (int8 [512, 256] t32, transposed
    plans): forward and gradients finite and within the gate of the
    float64 softmax, for stabilize=True and 'bound'; B2, B3 and B4 against
    their plain versions there.  C2: a row whose neighbors lie 200 logits
    below the global bound.  C4: the f16_split2 gathers run under
    torch.cuda.set_sync_debug_mode('error') with rows past 65504."""
    dev = gen.device
    log("phase 28: repairs on the card (C1 wide logits, C2 'bound' far below, C4 no host sync)")
    rng = np.random.default_rng(3)
    bd, bs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    dst = np.concatenate([bd.reshape(-1), rng.integers(0, 64, 600)])
    src = np.concatenate([bs.reshape(-1), rng.integers(0, 64, 600)])
    small = CSRGraph.from_edges(dst, src, 64)
    sagg = Aggregator.schedule_hybrid(small, tile_dtype=np.int8, tile_rows=16, tile_cols=16, threshold=60,
                                      residual_block=4, pack=1, device=dev)
    hs = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32)).to(dev)
    att0 = torch.from_numpy((rng.standard_normal((64, 2)) * 0.1).astype(np.float32)).to(dev)
    for big in (95.0, 120.0):
        att = att0.clone()
        att[5, 1] = big
        for stabilize in (True, "bound"):
            wide_logit_check(sagg, small, hs, att, stabilize, f"C1 16x16 as_5={big}")
    # C2: row 0's in-neighbors at as = -100, a far source at +100
    nbrs = np.unique(small.indices[small.indptr[0] : small.indptr[1]])
    far = next(j for j in range(16, 64) if j not in nbrs and (small.indices == j).any())
    att = att0.clone().clamp(-1.0, 1.0)
    att[torch.from_numpy(nbrs).to(dev), 1] = -100.0
    att[far, 1] = 100.0
    wide_logit_check(sagg, small, hs, att, "bound", "C2 far below the bound")

    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=1, device=dev,
                                     **GAT_SCHEDULE)
    n = g.num_nodes
    h = torch.randn((n, 32), generator=gen, device=dev)
    att = torch.randn((n, 2), generator=gen, device=dev)
    hub = int(torch.bincount(torch.from_numpy(g.indices.astype(np.int64)), minlength=n).argmax())
    att[hub, 1] = 120.0
    for stabilize in (True, "bound"):
        wide_logit_check(agg, g, h, att, stabilize, f"C1 GAT plan as_{hub}=120")
    err = 0.0
    with torch.no_grad():
        tp, tp_t = agg.tile, agg.tile_t
        for stabilize in (True, "bound"):
            shift = _resolve_shift(agg.tile_parts(), agg.plan, att, DEFAULT_SLOPE, stabilize)
            num, den = gat_bcsr(tp, h, att, row_shift=shift)
            ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=shift)
            gbar = torch.randn((n, 32), generator=gen, device=dev)
            c = torch.randn(n, generator=gen, device=dev)
            dm, asrc = _score_terms(att, shift)
            args = (h, gbar, c, dm, asrc, DEFAULT_SLOPE)
            dad, (dh, das) = gat_bwd_dad(tp, *args), gat_bwd_dh_das(tp_t, *args)
            want = (gat_bwd_dad_plain(tp, *args),) + gat_bwd_dh_das_plain(tp_t, *args)
            torch.cuda.synchronize()
            for got, ref, name in ((num, ref_num, "B2 num"), (den, ref_den, "B2 den"), (dad, want[0], "B3 d_ad"),
                                   (dh, want[1], "B4 dh"), (das, want[2], "B4 d_as")):
                err = max(err, compare(got, ref, f"C1 as=120 stabilize={stabilize!r} {name}", gate=False))
    # C4: every f16_split2 gather with rows past float16's range, no host sync
    plan = agg.plan
    hw = torch.randn((n, 32), generator=gen, device=dev)
    hw[hub] *= 3.0e5
    aw = att.clone()
    aw[hub, 1] = 1.0e6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        task = weighted_task_sums(plan, hw, plan.val, gather_dtype="f16_split2")
        slots = sddmm_slots(plan, hw, hw, gather_dtype="f16_split2")
        z = _att_slots_flat(plan, aw, gather_dtype="f16_split2")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for got, ref, name in (
        (task, weighted_task_sums(plan, hw.double(), plan.val), "weighted_task_sums"),
        (slots, sddmm_slots(plan, hw.double(), hw.double()), "sddmm_slots"),
        (z, _att_slots_flat(plan, aw.double()), "_att_slots_flat"),
    ):
        bad = relative_error_count(got, ref)
        log(f"  C4 {name} f16_split2 under sync-debug 'error', rows past 65504: gate_bad={bad} of {ref.numel()}")
        check(bool(torch.isfinite(got).all()) and bad == 0, f"C4 {name} off the float64 result")
    return dict(max_err=err)


def float_gat_kernels_vs_plain(tp, tp_t, f: int, gen, what: str) -> dict:
    """B2 and B5 over ``tp``, B3 over ``tp`` and B4 over ``tp_t`` (where
    given) against their plain versions: signed N(0, 1) h, gbar and c; att
    at scale 0.1 unshifted, at scale 15 with the exact row shift and with
    the 'bound' shift.  max|d| <= KERNEL_TOL * max|plain| for each output
    (den also under the gate where the plan's values are nonnegative), B5
    exactly equal.  Returns max|d| per kernel."""
    dev = tp.a.device
    n = tp.num_nodes
    nonneg = not bool((tp.a < 0).any())
    err = dict(B2=0.0, B3=0.0, B4=0.0)
    h = torch.randn((n, f), generator=gen, device=dev)
    gbar = torch.randn((n, f), generator=gen, device=dev)
    c = torch.randn(n, generator=gen, device=dev)
    for scale, shift in ((0.1, None), (15.0, "exact"), (15.0, "bound")):
        att = torch.randn((n, 2), generator=gen, device=dev) * scale
        rmax, want = bcsr_rowmax(tp, att[:, 1].contiguous()), bcsr_rowmax_plain(tp, att[:, 1].contiguous())
        torch.cuda.synchronize()
        check(torch.equal(rmax, want), f"{what} B5 differs from bcsr_rowmax_plain (scale {scale})")
        row_shift = {None: None, "exact": lambda: _hybrid_row_shift(tp, None, att, DEFAULT_SLOPE),
                     "bound": lambda: _global_bound_shift(att, DEFAULT_SLOPE)}[shift]
        row_shift = row_shift() if row_shift else None
        num, den = gat_bcsr(tp, h, att, row_shift=row_shift, dot_mode="split2")
        ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=row_shift)
        dm, asrc = _score_terms(att, row_shift)
        args = (h, gbar, c, dm, asrc, DEFAULT_SLOPE)
        outs = [(num, ref_num, "B2", "num", False), (den, ref_den, "B2", "den", nonneg),
                (gat_bwd_dad(tp, *args), gat_bwd_dad_plain(tp, *args), "B3", "d_ad", False)]
        if tp_t is not None:
            (dh, das), (want_dh, want_das) = gat_bwd_dh_das(tp_t, *args), gat_bwd_dh_das_plain(tp_t, *args)
            outs += [(dh, want_dh, "B4", "dh", False), (das, want_das, "B4", "d_as", False)]
        torch.cuda.synchronize()
        label = f"{what} f={f} scale {scale}{'' if shift is None else f' {shift}-shifted'}"
        for got, ref, k, name, gate in outs:
            err[k] = max(err[k], compare(got, ref, f"{label} {k} {name}", gate=gate))
    return err


def float_gat_kernel_phase(gen, plans: dict) -> dict:
    """Phase 29: B2, B5, B3 and B4 over float32 and bfloat16 tiles against
    their plain versions at every float path's shapes (``plans``: name ->
    (plan, transposed plan or None), pack 1 and padded), f = 128, 64, 32;
    the gcn_norm_val plan; a ragged float plan with a filler-only run and
    its transpose; a signed-value plan (U(-1, 3), C6); a non-edge whose
    unstabilized score is inf.  B6 over the same float plans (f = 32 and
    128; cells whose value is not > 0 are +0).  Returns max|d| per kernel
    and format over the pack-1 path plans."""
    dev = gen.device
    log("phase 29: B2-B6 over float32 / bfloat16 A vs their plain versions")
    max_err = {}
    with torch.no_grad():
        for name, (tp, tp_t) in plans.items():
            fmt = cuda_build.FORMAT_TAGS[tp.format]
            for f in BENCH_DIMS[1:]:
                errs = float_gat_kernels_vs_plain(tp, tp_t, f, gen, name)
                if "pack" not in name:
                    for k, e in errs.items():
                        max_err[f"{k}_{fmt}"] = max(max_err.get(f"{k}_{fmt}", 0.0), e)
            for f in (SDDMM_F, BENCH_DIMS[1]):
                e = sddmm_vs_plain(tp, f, gen, f"{name} B6")
                if "pack" not in name:
                    max_err[f"B6_{fmt}"] = max(max_err.get(f"B6_{fmt}", 0.0), e)
        ng, rng = ragged_graph()
        for label, val in (("ragged", rng.uniform(0.2, 2.0, ng.num_edges)), ("signed", rng.uniform(-1.0, 3.0, ng.num_edges))):
            host = densify(ng, val=val.astype(np.float32), **GAT_SCHEDULE)[0]
            rp, rp_t = host.pad_runs(16), host.transpose().pad_runs(16)
            check(bool(filler_only_runs(rp)) and bool(filler_only_runs(rp_t)), f"{label} float plan lacks a filler-only run")
            vals = rp.counts()
            log(f"  {label} float plan: n={ng.num_nodes} tiles={rp.num_tiles} (transposed {rp_t.num_tiles}), "
                f"filler-only runs {filler_only_runs(rp)}; cells < 0: {int((vals < 0).sum())}, > 0: {int((vals > 0).sum())}")
            for fmt in (np.float32, torch.bfloat16):
                p, p_t = rp.astype(fmt).to(dev), rp_t.astype(fmt).to(dev)
                for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
                    float_gat_kernels_vs_plain(p, p_t, f, gen, f"{label} {p.format}")
                    sddmm_vs_plain(p, f, gen, f"{label} {p.format} B6")
        for name, (tp, tp_t) in plans.items():
            if "pack" not in name and not bool((tp.a < 0).any()):
                bits_inf_non_edge(tp, tp_t, gen, name)
                break
    return max_err


def float_sddmm_checks(agg, cells, res, a, b, what: str):
    """Phase 32's checks of hybrid_sddmm over float tiles: every cell whose
    value is > 0 passes the gate against the float64 dot <b[row], a[col]>,
    every other cell is +0; every residual slot passes the gate and pad
    slots are 0 (residual_checks)."""
    dev = a.device
    a64, b64 = a.double(), b.double()
    bad, edges = 0, 0
    for p, c in zip(agg.tile_parts(), cells):
        check(c.shape == (p.num_tiles, p.tile_rows, p.tile_cols), f"{what}: cell array shape")
        for s in range(0, p.num_tiles, CHECK_TILES):
            on = p.counts(s, s + CHECK_TILES) > 0
            cs = c[s : s + CHECK_TILES]
            raw = cs.view(torch.int16) if cs.dtype == torch.bfloat16 else cs.view(torch.int32)
            check(not bool(((raw != 0) & ~on).any()), f"{what}: a cell whose value is not > 0 is not +0")
            check(bool(torch.isfinite(cs.float()).all()), f"{what}: non-finite cell")
            t, i, j = on.nonzero(as_tuple=True)
            rows = p.tile_row.long()[s + t] * p.tile_rows + i
            cols = p.tile_col.long()[s + t] * p.tile_cols + j
            ref = (b64.index_select(0, rows) * a64.index_select(0, cols)).sum(dim=1)
            bad += relative_error_count(cs[t, i, j].float(), ref)
            edges += int(t.numel())
    log(f"  {what} cells vs f64 dots: gate_bad={bad} of {edges}")
    check(bad == 0, f"{what}: cells fail the gate against the f64 dots")
    residual_checks(agg.plan, res, a64, b64, f"{what} ")


def float_gat_phases(g, h0, gen, forwards: int) -> dict:
    """Phases 29-33 (quick scale): GAT and SDDMM over float tiles.  Phase 29
    the kernels against their plain versions; 30 (G1) the GAT forward over
    the JAX default schedule; 31 (G2) bench.py --model gat --tile-dtype
    bf16; 32 (T) GAT training over float tiles; 33 (S) hybrid_sddmm over
    float32 plans; then their timing.  Returns what the report needs."""
    dev = h0.device
    n, m = g.num_nodes, g.num_edges
    model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    params = model.layer_params()
    t0 = time.perf_counter()
    # G1: the JAX package's defaults (float32 count tiles [256, 128], the
    # default threshold, residual block 8, transposed plans), pack 1
    agg1 = Aggregator.schedule_hybrid(g, pack=1, device=dev)
    g1_s = time.perf_counter() - t0
    host1 = densify(g)[0]
    g1_8, g1_t8 = host1.pad_runs(8).to(dev), host1.transpose().pad_runs(8).to(dev)
    del host1
    # G2: bench.py --model gat --tile-dtype bf16
    agg2 = Aggregator.schedule_hybrid(g, tile_dtype=torch.bfloat16, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                      pack=1, device=dev, **GAT_SCHEDULE)
    g2_8 = densify(g, dtype=torch.bfloat16, **GAT_SCHEDULE)[0].pad_runs(8).to(dev)
    # T: bench.py --train --model gat --tile-dtype bf16's plan, built as that
    # command builds it (host bfloat16 densify and transpose), and the same
    # plan in float32 (the JAX default dtype); the bf16 tiles must be the
    # float32 sums rounded to nearest even
    aggt = Aggregator.schedule_hybrid(g, tile_dtype=np.float32, residual_block=RESIDUAL_BLOCK, pack=1,
                                      with_transpose=True, device=dev, **TRAIN_SCHEDULE)
    aggt_bf = Aggregator.schedule_hybrid(g, tile_dtype=torch.bfloat16, residual_block=RESIDUAL_BLOCK, pack=1,
                                         with_transpose=True, device=dev, **TRAIN_SCHEDULE)
    for got, want in ((aggt_bf.tile, aggt.tile), (aggt_bf.tile_t, aggt.tile_t)):
        check(got.format == "bfloat16" and torch.equal(got.a, want.a.to(torch.bfloat16))
              and torch.equal(got.tile_col, want.tile_col) and torch.equal(got.run_start, want.run_start),
              "T's bf16 plan (schedule_hybrid tile_dtype=bfloat16) is not its float32 plan rounded to bf16")
    hostt = densify(g, dtype=np.float32, **TRAIN_SCHEDULE)[0]
    t16, t_t16 = hostt.pad_runs(16).to(dev), hostt.transpose().pad_runs(16).to(dev)
    del hostt
    # the weighted plan of phases 22-24: gcn_norm_val, float32 [512, 256] t48
    aggn = Aggregator.schedule_hybrid(g, val=g.gcn_norm_val(), residual_block=RESIDUAL_BLOCK, pack=1, device=dev,
                                      **SCHEDULE)
    for name, a in (("G1 (JAX defaults)", agg1), ("G2 (bf16 [512, 256] t32)", agg2), ("T (f32 [256, 256] t24)", aggt),
                    ("gcn_norm_val (f32 [512, 256] t48)", aggn)):
        tp = a.tile
        log(f"{name} plan: {tp.format} [{tp.tile_rows}, {tp.tile_cols}] tiles={tp.num_tiles}"
            + (f" (transposed {a.tile_t.num_tiles})" if a.tile_t is not None else "")
            + f" A bytes={tp.a.numel() * tp.a.element_size()} dense_edges={tp.num_dense_edges} "
            f"residual_edges={a.plan.num_edges} (block {a.plan.block_size}) longest run={int(tp.run_start.diff().max())}")
    check(agg1.tile.format == "float32" and agg1.tile_t.format == "float32" and agg1.plan.block_size == 8,
          "schedule_hybrid's defaults are not float32 tiles with transposes and residual block 8")
    log(f"  G1 plan built in {g1_s:.1f} s; all float plans in {time.perf_counter() - t0:.1f} s")

    # ---- phase 29: the kernels against their plain versions
    packed = {"T_f32": (t16, t_t16), "T_bf16": (t16.astype(torch.bfloat16), t_t16.astype(torch.bfloat16))}
    max_err = float_gat_kernel_phase(gen, {
        "G1 f32": (agg1.tile, agg1.tile_t), "G1 f32 pack8": (g1_8, g1_t8),
        "G2 bf16": (agg2.tile, None), "G2 bf16 pack8": (g2_8, None),
        "T f32": (aggt.tile, aggt.tile_t), "T f32 pack16": packed["T_f32"],
        "T bf16": (aggt_bf.tile, aggt_bf.tile_t), "T bf16 pack16": packed["T_bf16"],
        "gcn_norm_val f32": (aggn.tile, aggn.tile_t),
    })
    packed.update(G1=g1_8, G2=g2_8)
    # wide logits (C1) through B2-B4 over float tiles: one source's as at
    # 95 and 120, kernels against their plain versions, forward and
    # gradients against the float64 softmax
    hw = torch.randn((n, 32), generator=gen, device=dev)
    hub = int(torch.bincount(torch.from_numpy(g.indices.astype(np.int64)), minlength=n).argmax())
    with torch.no_grad():
        for big in (95.0, 120.0):
            att = torch.randn((n, 2), generator=gen, device=dev)
            att[hub, 1] = big
            gbar, c = torch.randn((n, 32), generator=gen, device=dev), torch.randn(n, generator=gen, device=dev)
            for stabilize in (True, "bound"):
                shift = _resolve_shift(agg1.tile_parts(), agg1.plan, att, DEFAULT_SLOPE, stabilize)
                num, den = gat_bcsr(agg1.tile, hw, att, row_shift=shift)
                want = gat_bcsr_plain(agg1.tile, hw, att, row_shift=shift)
                dm, asrc = _score_terms(att, shift)
                args = (hw, gbar, c, dm, asrc, DEFAULT_SLOPE)
                dad, (dh, das) = gat_bwd_dad(agg1.tile, *args), gat_bwd_dh_das(agg1.tile_t, *args)
                wb = (gat_bwd_dad_plain(agg1.tile, *args),) + gat_bwd_dh_das_plain(agg1.tile_t, *args)
                torch.cuda.synchronize()
                for got, ref, name in ((num, want[0], "B2 num"), (den, want[1], "B2 den"), (dad, wb[0], "B3 d_ad"),
                                       (dh, wb[1], "B4 dh"), (das, wb[2], "B4 d_as")):
                    compare(got, ref, f"G1 f32 as_{hub}={big} stabilize={stabilize!r} {name}", gate=False)
    att = torch.randn((n, 2), generator=gen, device=dev)
    att[hub, 1] = 120.0
    for stabilize in (True, "bound"):
        wide_logit_check(agg1, g, hw, att, stabilize, f"C1 G1 f32 plan as_{hub}=120")
    del g1_t8, hw, att
    torch.cuda.empty_cache()

    def fwd(agg, **kw):
        return model(agg, h0, fast=True, dot_mode="split2", **kw)

    res = {"max_err": max_err}
    for key, agg, label, layer_limit in (
        ("G1", agg1, "phase 30: G1, the GAT forward over the JAX default schedule (float32 tiles)", 0.0),
        # bfloat16 rounds an odd count above 256 in a hub cell, as the JAX
        # package's bfloat16 tiles do (phase 25): held to PURE_BAD_FRACTION
        ("G2", agg2, "phase 31: G2, bench.py --model gat --tile-dtype bf16 (bfloat16 count tiles)", PURE_BAD_FRACTION),
    ):
        log(f"{label}, fast=True, split2")
        with torch.no_grad():
            reset_counts()
            for _ in range(forwards):
                out = fwd(agg)
            torch.cuda.synchronize()
            c_fwd = (cuda_gat.launches, cuda_gat.float_launches)
            log(f"  B2 launches in {forwards} forwards: {c_fwd[0]}, float tiles: {c_fwd[1]}")
            check(only("B2") and c_fwd == (3 * forwards, 3 * forwards), f"{key}: B2 not 3 float launches a forward")
            check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), f"{key} forward output")
            vals = agg.tile.a
            log(f"  cells above 256 (bfloat16 rounds odd counts there): {int((vals > 256).sum())}")
            del vals
            xs = gat_gates(agg, params, h0, out, g, f"{key} ", layer_limit)
            reset_counts()
            out_exact = fwd(agg, stabilize=True)
            torch.cuda.synchronize()
            c_stab = (cuda_rowmax.launches, cuda_rowmax.float_launches, cuda_gat.launches, cuda_gat.float_launches)
            log(f"  stabilize=True: B5 launches {c_stab[0]} ({c_stab[1]} float), B2 {c_stab[2]} ({c_stab[3]} float)")
            check(c_stab == (3, 3, 3, 3), f"{key} stabilize=True: B5 and B2 not 3 float launches each")
            reset_counts()
            out_bound = fwd(agg, stabilize="bound")
            torch.cuda.synchronize()
            check(cuda_gat.float_launches == 3, f"{key} stabilize='bound': B2 not 3 float launches")
            for lbl, o in (("stabilize=True", out_exact), ("stabilize='bound'", out_bound)):
                bad = relative_error_count(o, out)
                log(f"  {lbl} vs un-stabilized: gate_bad={bad}")
                check(bool(torch.isfinite(o).all()) and bad == 0, f"{key} {lbl} differs from the un-stabilized forward")
        res[key] = dict(agg=agg, xs=xs, launches=c_fwd[1], stab_launches=c_stab[1])

    # ---- phase 32: T, GAT training over float tiles
    for key, agg in (("T_bf16", aggt_bf), ("T_f32", aggt)):
        log(f"phase 32: {key}: GAT training over {agg.tile.format} tiles [256, 256] t24 and their transpose, "
            f"{TRAIN_STEPS} steps (fast=False, stabilize='bound', split2, Adam 1e-3)")
        tr = gat_training(agg, g, h0, f"{key} ")
        fc = float_counts()
        for k in ("B2", "B3", "B4"):
            check(tr["counts"][k] == 3 * TRAIN_STEPS and fc[k] == 3 * TRAIN_STEPS,
                  f"{key}: {k} not 3 float launches a step")
        check(tr["counts"]["B1"] == 0 and tr["counts"]["B5"] == 0, f"{key} launched B1 or B5")
        res[key] = dict(agg=agg, train=tr, float_counts=fc)

    # ---- phase 33: S, hybrid_sddmm over float32 plans
    a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
    b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
    for key, agg in (("S_G1", agg1), ("S_gcn_norm", aggn)):
        log(f"phase 33: {key}: hybrid_sddmm over {agg.tile.format} tiles [{agg.tile.tile_rows}, {agg.tile.tile_cols}], "
            f"f={SDDMM_F}, {SDDMM_CALLS} calls")
        parts = agg.tile_parts()
        plan = agg.plan if agg.plan.num_edges else None
        with torch.no_grad():
            reset_counts()
            for _ in range(SDDMM_CALLS):
                cells, r = hybrid_sddmm(parts, plan, a, b)
            torch.cuda.synchronize()
            c6 = (cuda_sddmm.launches, cuda_sddmm.float_launches)
            log(f"  B6 launches in {SDDMM_CALLS} calls: {c6[0]}, float tiles: {c6[1]}")
            check(only("B6") and c6 == (SDDMM_CALLS * len(parts),) * 2, f"{key}: B6 not one float launch a part a call")
            float_sddmm_checks(agg, cells, r, a, b, key)
            del cells, r
        res[key] = dict(agg=agg, launches=c6[1])

    # ---- timing
    log("phases 30-33 timing (CUDA events, median of 10 after 3 warm-up)")
    with torch.no_grad():
        for key in ("G1", "G2"):
            agg, xs, tp_pack = res[key]["agg"], res[key]["xs"], packed.pop(key)
            res[key]["forward_ms"] = cuda_time_ms(lambda: fwd(agg))
            res[key]["stab_ms"] = cuda_time_ms(lambda: fwd(agg, stabilize=True))
            res[key]["bound_ms"] = cuda_time_ms(lambda: fwd(agg, stabilize="bound"))
            log(f"  {key} GAT forward {res[key]['forward_ms']:.3f} ms; stabilize=True {res[key]['stab_ms']:.3f}; "
                f"'bound' {res[key]['bound_ms']:.3f}")
            res[key]["rows2"] = b2_rows(agg, agg.tile, tp_pack, 8, xs, params)
            res[key]["rows5"] = b5_rows(agg.tile, tp_pack, xs, params, 8)
            del tp_pack
    for key in ("T_bf16", "T_f32"):
        agg, tr = res[key]["agg"], res[key]["train"]
        times = dict(step_ms=cuda_time_ms(tr["step"]), forward_ms=cuda_time_ms(lambda: tr["fwd"](h0)))
        times["backward_adam_ms"] = times["step_ms"] - times["forward_ms"]
        log(f"  {key} GAT step {times['step_ms']:.3f} ms = forward {times['forward_ms']:.3f} "
            f"+ backward and Adam {times['backward_adam_ms']:.3f}")
        p16, p_t16 = packed.pop(key)
        with torch.no_grad():
            res[key]["rows"] = train_kernel_times(agg.tile, agg.tile_t, p16, p_t16, gen)
        res[key]["times"] = times
        del p16, p_t16
    with torch.no_grad():
        for key in ("S_G1", "S_gcn_norm"):
            agg = res[key]["agg"]
            parts = agg.tile_parts()
            plan = agg.plan if agg.plan.num_edges else None
            path_ms = cuda_time_ms(lambda: hybrid_sddmm(parts, plan, a, b))
            res_ms = cuda_time_ms(lambda: sddmm_slots(plan, a, b)) if plan is not None else 0.0
            log(f"  {key} SDDMM pass {path_ms:.3f} ms, {m / (path_ms / 1e3):.4e} edges/s; residual {res_ms:.3f} ms")
            res[key].update(path_ms=path_ms, edges_per_s=m / (path_ms / 1e3), residual_ms=res_ms,
                            rows=[b6_row(p, a, b, key) for p in parts])
        res["S_bf16"] = dict(rows=[b6_row(agg2.tile, a, b, "G2 bf16 plan")])
    return res


def b6_row(p, a, b, what: str) -> dict:
    """B6's timing row over one part at f = a.shape[1]: ms a launch, the
    plain version, torch.sparse.sampled_addmm of b a^T on the cells' CSR
    (built outside the timed call) and the bound (A's bytes read, bf16
    cells written, a and b read; 2 f FLOPs a cell with an edge)."""
    n, f = b.shape
    at = a.t().contiguous()
    c_dst, c_src, c_val = tile_cells(p)
    on = c_val > 0
    c_dst, c_src = c_dst[on], c_src[on]
    nnz = int(c_dst.numel())
    csr = cells_csr(c_dst, c_src, torch.ones(nnz, device=a.device), (n, p.n_src))
    lib = torch.sparse.sampled_addmm(csr, b, at, beta=0.0)
    r, c = csr_rows(lib), lib.col_indices()
    ref = (b.index_select(0, r) * a.index_select(0, c)).sum(dim=1)
    check((lib.values() - ref).abs().max() <= 1e-4 * ref.abs().max(), "sampled_addmm yardstick disagrees")
    t = p.num_tiles
    row = dict(
        part=part_name(p), f=f, tiles=t, nnz_cells=nnz,
        ms=cuda_time_ms(lambda: cuda_sddmm.sddmm_bcsr_cuda(p, a, b)),
        plain_ms=cuda_time_ms(lambda: sddmm_bcsr_plain(p, a, b)),
        library_ms=cuda_time_ms(lambda: torch.sparse.sampled_addmm(csr, b, at, beta=0.0)),
        **bound(p.a.numel() * p.a.element_size() + 2 * t * p.tile_rows * p.tile_cols + 8 * t + 4 * f * (p.n_src + n),
                2.0 * nnz * f),
    )
    log(f"  B6 {what} ({row['part']}, {t} tiles): {row['ms']:.3f} ms/launch bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}) | plain {row['plain_ms']:.3f} | sampled_addmm {row['library_ms']:.3f}")
    del csr, lib, ref
    return row


# ------------------------------------------------ phases 34-36 (B2's modes, P1, P2)
MODE_CASES = (("twodot", 2), ("twodot", 1), ("merged", 2), ("merged", 1))
# B2 'default' against its plain version must lie this far nearer to it
# than to the exact plain version (L2 of the differences): the kernel
# rounds the scores and h as 'default' does
DEFAULT_ROUNDING_RATIO = 2.0**-3
# wide logits, factored modes: max|out - softmax| / max|softmax| (twodot with
# two chunks is also held to the gate); merged is held to its two bf16
# roundings, never to the gate
WIDE_TOL = {("twodot", 2): 1e-5, ("twodot", 1): 5e-3, ("merged", 2): 2.0**-7, ("merged", 1): 2.0**-7}
PROBE_F = 128  # gnn_computing_tpu_torch/probes/overlap_dma_residual.py --f default


def default_vs_plain(tp, h, att, shift, what: str) -> float:
    """B2 'default' against gat_bcsr_plain(dot_mode='default'): num within
    KERNEL_TOL * max|plain| plus one bfloat16 ulp (<= 2^-7) of each rounded
    score times |h| (the kernel's __expf score and torch.exp may round to
    neighbouring bf16 values), den within KERNEL_TOL and the gate; and the
    rounding shown: the L2 of num's differences to the 'default' plain
    version at most DEFAULT_ROUNDING_RATIO of those to the exact one."""
    before = (cuda_gat.launches, cuda_gat.default_launches)
    num, den = gat_bcsr(tp, h, att, row_shift=shift, dot_mode="default")
    check((cuda_gat.launches, cuda_gat.default_launches) == (before[0] + 1, before[1] + 1), f"{what}: B2 'default' launch")
    ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=shift, dot_mode="default")
    exact_num = gat_bcsr_plain(tp, h, att, row_shift=shift)[0]
    a_abs = dataclasses.replace(tp, a=tp.a.abs()) if tp.format in ("float32", "bfloat16") else tp
    ulp = 2.0**-7 * gat_bcsr_plain(a_abs, h.abs(), att, row_shift=shift)[0] * (1 + 2.0**-7)
    torch.cuda.synchronize()
    d = (num - ref_num).abs()
    scale = ref_num.abs().max().item()
    beyond = int((d > KERNEL_TOL * scale + ulp).sum())
    off = int((d > KERNEL_TOL * scale).sum())
    d_exact = num - exact_num
    ratio = (d.norm() / d_exact.norm()).item()
    log(f"  {what} default num: max|d|={d.max().item():.3e} max|ref|={scale:.3e}; {off} elements past "
        f"{KERNEL_TOL:g}*max (bf16 ulp flips), {beyond} past one bf16 ulp a score; to the exact plain version "
        f"max|d|={d_exact.abs().max().item():.3e}, L2 ratio {ratio:.3e}")
    check(bool(torch.isfinite(num).all()) and beyond == 0, f"{what}: B2 'default' num off its plain version")
    check(ratio <= DEFAULT_ROUNDING_RATIO, f"{what}: B2 'default' is not nearer its plain version than the exact one")
    compare(den, ref_den, f"{what} default den", gate=True)
    return d.max().item()


def factored_vs_plain(tp, h, att, shift, mode, hv, what: str) -> float:
    """The factored kernel against _factored_sums over the same per-node
    operands (rows not marked for rescue), then gat_bcsr_tiles (kernel and
    B2 for the rescued rows) against the same on the plain versions."""
    counter = f"{mode}_launches"
    before = getattr(cuda_gat, counter)
    num, den, need = gat_bcsr_factored(tp, h, att, DEFAULT_SLOPE, mode, hv, shift)
    check(getattr(cuda_gat, counter) == before + 1, f"{what}: {mode} kernel launch")
    terms = factored_terms(h, att, DEFAULT_SLOPE, mode, hv, shift)
    ref_num, ref_den = _factored_sums(tp, terms, mode)
    torch.cuda.synchronize()
    keep = ~need
    label = f"{what} {mode} hv{hv}"
    err = compare(num[keep], ref_num[keep], f"{label} num (rows held: {int(keep.sum())})", gate=False)
    compare(den[keep], ref_den[keep], f"{label} den", gate=False)
    if bool(need.any()):
        got = gat_bcsr_tiles(tp, h, att, DEFAULT_SLOPE, mode=mode, hv_chunks=hv, row_shift=shift)
        exact = gat_bcsr_plain(tp, h, att, row_shift=shift)
        want = (torch.where(need[:, None], exact[0], ref_num), torch.where(need, exact[1], ref_den))
        torch.cuda.synchronize()
        compare(got[0], want[0], f"{label} num with {int(need.sum())} rows rescued", gate=False)
        compare(got[1], want[1], f"{label} den with rows rescued", gate=False)
    return err


def cell_softmax(tp, h, att) -> torch.Tensor:
    """float64 softmax over each row's tile cells (count multiplicity), the
    row's max logit as its shift; rows without a cell give 0."""
    rows, cols, cnt = tile_cells(tp)
    n = tp.num_nodes
    a64 = att.double()
    z = a64[rows, 0] + a64[cols, 1]
    lz = torch.maximum(z, DEFAULT_SLOPE * z)
    mx = torch.full((n,), -torch.inf, dtype=torch.float64, device=h.device).scatter_reduce(0, rows, lz, "amax")
    s = cnt * torch.exp(lz - mx[rows])
    den = torch.zeros(n, dtype=torch.float64, device=h.device).index_add_(0, rows, s)
    num = edge_sum(h.double(), rows, cols, s)
    return num / torch.where(den == 0, 1.0, den)[:, None]


def wide_factored_check(tp, h, att, stabilize, what: str) -> dict:
    """Phase 34's wide logits: every factored mode through gat_bcsr_tiles on
    the card ('bound' with hybrid_gat's C2 rescue first) against the float64
    softmax over the tile cells — finite everywhere, within WIDE_TOL (twodot
    with two chunks also within the gate, absolute floor 1e-5 * max|ref|) —
    and against the same on the plain versions.  Returns the rows rescued
    per mode."""
    want = cell_softmax(tp, h, att)
    scale = want.abs().max().item()
    rescued = {}
    for mode, hv in MODE_CASES:
        before = dict(bcsr_gat.rescued)
        shift = _resolve_shift(tp, None, att, DEFAULT_SLOPE, stabilize)
        num, den = gat_bcsr_tiles(tp, h, att, DEFAULT_SLOPE, mode=mode, hv_chunks=hv, row_shift=shift)
        if stabilize == "bound":
            shift = _bound_rescue(tp, None, att, DEFAULT_SLOPE, shift, den, None)
            if shift is not None:
                num, den = gat_bcsr_tiles(tp, h, att, DEFAULT_SLOPE, mode=mode, hv_chunks=hv, row_shift=shift)
        out = num / torch.where(den == 0, 1.0, den)[:, None]
        terms = factored_terms(h, att, DEFAULT_SLOPE, mode, hv, shift)
        exact = gat_bcsr_plain(tp, h, att, row_shift=shift)
        plain = _factored_sums(tp, terms, mode)
        need = terms.need[: tp.num_nodes]
        p_num, p_den = torch.where(need[:, None], exact[0], plain[0]), torch.where(need, exact[1], plain[1])
        torch.cuda.synchronize()
        label = f"{what} stabilize={stabilize!r} {mode} hv{hv}"
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite where the float64 softmax is finite")
        err = (out.double() - want).abs().max().item()
        bad = relative_error_count(out, want, 1e-2, max(1e-5, KERNEL_TOL * scale))
        rescued[f"{mode}{hv}"] = bcsr_gat.rescued["rows"] - before["rows"]
        log(f"  {label}: vs f64 softmax max|d|={err:.3e} max|ref|={scale:.3e} gate_bad={bad}; "
            f"rows rescued {rescued[f'{mode}{hv}']} (marked now {int(need.sum())})")
        check(err <= WIDE_TOL[(mode, hv)] * scale, f"{label}: off the float64 softmax")
        check(bad == 0 or (mode, hv) != ("twodot", 2), f"{label}: off the gate of the float64 softmax")
        compare(num, p_num, f"{label} num vs plain", gate=False)
        compare(den, p_den, f"{label} den vs plain", gate=False)
    return rescued


def mode_rows(tp, xs, params, what: str) -> list:
    """Phase 34's timing rows (Figure 10a's ablation) over ``tp``, one a GAT
    layer from its own input: ms a launch of B2 maxdot ('exact' = 'split2'
    here), B2 'default' and the factored kernel in each MODE_CASES (its
    per-node operands formed outside the timed call, and gat_bcsr_tiles
    with them inside), the plain versions (5 timed calls) and the library
    yardstick and bound of B2 (b2_rows)."""
    dev = tp.a.device
    n = tp.num_nodes
    c_dst, c_src, c_cnt = tile_cells(tp)
    nnz = c_cnt.numel()
    move_plan = tp.a.numel() * tp.a.element_size() + 4 * (tp.num_tiles + tp.num_row_tiles + 1)
    rows = []
    for i, p in enumerate(params):
        feat = (xs[i] @ p.w).contiguous()
        att = feat @ p.w_att
        f = feat.shape[1]
        dm, asrc = _score_terms(att)
        row = dict(f=f, tiles=tp.num_tiles, nnz_cells=nnz)
        row["maxdot_ms"] = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, feat, dm, asrc, DEFAULT_SLOPE))
        row["default_ms"] = cuda_time_ms(lambda: cuda_gat.gat_bcsr_cuda(tp, feat, dm, asrc, DEFAULT_SLOPE, bf16_dot=True))
        for mode, hv in MODE_CASES:
            terms = factored_terms(feat, att, DEFAULT_SLOPE, mode, hv)
            check(not bool(terms.need.any()), f"{what}: a row marked for rescue at the layer's own logits")
            rws = terms.rows[:n].contiguous()
            row[f"{mode}{hv}_ms"] = cuda_time_ms(lambda: cuda_gat.gat_bcsr_factored_cuda(tp, mode, terms.hv, rws, terms.cols))
            row[f"{mode}{hv}_entry_ms"] = cuda_time_ms(
                lambda: gat_bcsr_tiles(tp, feat, att, DEFAULT_SLOPE, mode=mode, hv_chunks=hv)
            )
        row["default_plain_ms"] = cuda_time_ms(lambda: gat_bcsr_plain(tp, feat, att, dot_mode="default"), iters=5)
        row["twodot2_plain_ms"] = cuda_time_ms(lambda: gat_bcsr_twodot_plain(tp, feat, att), iters=5)
        row["merged2_plain_ms"] = cuda_time_ms(lambda: gat_bcsr_merged_plain(tp, feat, att), iters=5)
        z = att[c_dst, 0] + att[c_src, 1]
        score = c_cnt.float() * torch.exp(torch.maximum(z, DEFAULT_SLOPE * z))
        csr = cells_csr(c_dst, c_src, score, (n, tp.n_src))
        hx = torch.cat([feat, torch.ones((feat.shape[0], 1), device=dev)], dim=1)
        row["library_ms"] = cuda_time_ms(lambda: torch.sparse.mm(csr, hx))
        del csr, hx, z, score
        row.update(bound(move_plan + 4 * f * tp.n_src + 8 * n + 4 * tp.n_src + 4 * (f + 1) * n, 2.0 * nnz * (f + 1)))
        rows.append(row)
        log(f"  {what} layer {i + 1} f={f}: B2 maxdot {row['maxdot_ms']:.3f} default {row['default_ms']:.3f} | "
            + " ".join(f"{m}{c} {row[f'{m}{c}_ms']:.3f} (entry {row[f'{m}{c}_entry_ms']:.3f})" for m, c in MODE_CASES)
            + f" ms | bound {row['bound_ms']:.4f} ({row['bound_by']})"
            + f" | plain default {row['default_plain_ms']:.3f} twodot2 {row['twodot2_plain_ms']:.3f} merged2 "
              f"{row['merged2_plain_ms']:.3f} | torch.sparse.mm {row['library_ms']:.3f}")
    return rows


def mode_phases(g, h0, gen, forwards: int) -> dict:
    """Phases 34-35: B2's other modes against their plain versions (34: the
    GAT plan of phase 6, its 1-bit part and G1's float32 plan, f = 128, 64,
    32; wide logits; Figure 10a's ablation path and timing), then the
    --gat-dot-mode default paths (35: five forwards of bench.py --model gat,
    five GAT training steps)."""
    dev = h0.device
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1,
                                     device=dev, **GAT_SCHEDULE)
    bits = split_bit_tiles(densify(g, dtype=np.int8, **GAT_SCHEDULE)[0])[0].to(dev)
    g1 = Aggregator.schedule_hybrid(g, pack=1, with_transpose=False, device=dev).tile
    plans = {"GAT int8 [512, 256] t32": agg.tile, "its 1-bit part": bits, "G1 float32 [256, 128]": g1}
    log(f"phase 34 plans: " + "; ".join(f"{k}: {p.format} tiles={p.num_tiles}" for k, p in plans.items())
        + f"; built in {time.perf_counter() - t0:.1f} s")

    # ---- phase 34: the kernels against their plain versions
    log("phase 34: B2 'default', 'twodot' and 'merged' kernels vs their plain versions")
    max_err = dict(default=0.0, twodot=0.0, merged=0.0)
    with torch.no_grad():
        for label, tp in plans.items():
            for f in BENCH_DIMS[1:]:
                h = torch.randn((tp.n_src, f), generator=gen, device=dev)
                for shift_kind in (None, "exact", "bound"):
                    att = torch.randn((tp.num_nodes, 2), generator=gen, device=dev) * 0.3
                    shift = None if shift_kind is None else _resolve_shift(tp, None, att, DEFAULT_SLOPE,
                                                                         True if shift_kind == "exact" else "bound")
                    what = f"{label} f={f} shift={shift_kind}"
                    e = default_vs_plain(tp, h, att, shift, what)
                    if tp is agg.tile:
                        max_err["default"] = max(max_err["default"], e)
                    for mode, hv in MODE_CASES:
                        e = factored_vs_plain(tp, h, att, shift, mode, hv, what)
                        if tp is agg.tile:
                            max_err[mode] = max(max_err[mode], e)
        n = g.num_nodes
        hub = int(torch.bincount(torch.from_numpy(g.indices.astype(np.int64)), minlength=n).argmax())
        hw = torch.randn((n, BENCH_DIMS[3]), generator=gen, device=dev)
        aw = torch.randn((n, 2), generator=gen, device=dev) * 0.3
        wide = {}
        for big in (95.0, 120.0):
            att = aw.clone()
            att[hub, 1] = big
            for stabilize in (True, "bound"):
                wide[f"as{int(big)}_{stabilize}"] = wide_factored_check(
                    agg.tile, hw, att, stabilize, f"as_{hub}={big}"
                )
        log(f"  rescues over the whole phase: {bcsr_gat.rescued}")

        # Figure 10a's ablation path: gat_bcsr_tiles in each mode over the
        # GAT plan's tiles, one call a layer from the 3-layer forward's inputs
        model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
        params = model.layer_params()
        xs = [h0]
        for p in params:
            xs.append(gat_forward(agg, [p], xs[-1], fast=True, dot_mode="split2"))
        reset_counts()
        for mode, hv in MODE_CASES:
            for i, p in enumerate(params):
                feat = xs[i] @ p.w
                num, den = gat_bcsr_tiles(agg.tile, feat, feat @ p.w_att, DEFAULT_SLOPE, mode=mode, hv_chunks=hv)
                check(bool(torch.isfinite(num).all()) and bool(torch.isfinite(den).all()), f"ablation {mode}{hv}")
        torch.cuda.synchronize()
        ablation = counts()
        log(f"  ablation path (gat_bcsr_tiles, 3 layers x {len(MODE_CASES)} modes): launches {ablation}")
        check(ablation["B2_twodot"] == 6 and ablation["B2_merged"] == 6 and only_of(("B2_twodot", "B2_merged")),
              "ablation path: twodot / merged did not launch 3 times a mode each, or another kernel ran")
        rows = {label: mode_rows(tp, xs, params, label) for label, tp in plans.items()}

        # ---- phase 35: --gat-dot-mode default
        log("phase 35: bench.py --model gat --gat-dot-mode default (5 forwards), GAT training steps")

        def fwd(mode):
            return model(agg, h0, fast=True, dot_mode=mode)

        out_split2 = fwd("split2")
        reset_counts()
        for _ in range(forwards):
            out = fwd("default")
        torch.cuda.synchronize()
        fwd_counts = dict(counts(), B2_default=cuda_gat.default_launches)
        log(f"  launches in {forwards} 'default' forwards: {fwd_counts}")
        check(cuda_gat.default_launches == 3 * forwards and cuda_gat.launches == 3 * forwards and only("B2"),
              "'default' forward: B2 did not launch 3 'default' times per forward, or another kernel ran")
        check(out.shape == out_split2.shape and bool(torch.isfinite(out).all()), "'default' forward output")
        off = relative_error_count(out, out_split2)
        off_share = off / out.numel()
        log(f"  'default' forward vs the split2 forward: {off} of {out.numel()} elements outside the 1e-2 gate "
            f"({off_share:.4%})")
        check(off > 0, "'default' forward: no element off the split2 forward's gate, so no bf16 rounding shows")
        layer_off = []
        for i, p in enumerate(params):
            o = gat_forward(agg, [p], xs[i], fast=True, dot_mode="default")
            layer_off.append(relative_error_count(o, xs[i + 1]) / o.numel())
        log(f"  per layer from the split2 forward's inputs: off-gate shares {[f'{v:.4%}' for v in layer_off]}")
        times = dict(default_forward_ms=cuda_time_ms(lambda: fwd("default")),
                     split2_forward_ms=cuda_time_ms(lambda: fwd("split2")))
        log(f"  forward: 'default' {times['default_forward_ms']:.3f} ms, split2 {times['split2_forward_ms']:.3f} ms")
    del plans, bits, g1
    torch.cuda.empty_cache()
    aggt = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=1, with_transpose=True,
                                      device=dev, **TRAIN_SCHEDULE)
    train = gat_training(aggt, g, h0, "'default' ", dot_mode="default")
    check(train["counts"]["B2"] == 3 * TRAIN_STEPS and train["counts"]["B3"] == 3 * TRAIN_STEPS
          and train["counts"]["B4"] == 3 * TRAIN_STEPS and train["default_launches"] == 3 * TRAIN_STEPS,
          "'default' GAT training: B2 ('default'), B3 and B4 did not launch 3 times per step")
    faults = planted_faults(aggt, h0, train)
    times["default_step_ms"] = cuda_time_ms(train["step"])
    log(f"  'default' GAT training step {times['default_step_ms']:.3f} ms")
    return dict(max_err=max_err, wide=wide, ablation=ablation, rows=rows, forward_counts=fwd_counts,
                off_share=off_share, layer_off=layer_off, times=times, train_losses=train["losses"],
                train_rel_l2=train["rel_l2"], train_counts=train["counts"], planted_faults=faults)


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """module.name replaced by wrap(the original) inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def planted_faults(agg, h0, train: dict) -> dict:
    """Phase 35's planted faults: the first step's gradients of the
    'default' GAT (the same weights, glorot seed 0) with a backward that
    drops the residual's attention gradient, and with one whose tile d ad
    is 2^-7 short, each against the float64 chain of gat_training.  Each
    fault's largest relative L2 must exceed GRAD_REL_L2, which the sound
    step's lie below."""
    readings = {}
    faults = {
        "residual attention gradient dropped": (bcsr_gat, "_residual_bwd_flat", lambda f: lambda *a: (
            lambda r: (r[0], torch.zeros_like(r[1]), torch.zeros_like(r[2])))(f(*a))),
        "tile d ad 2^-7 short": (bcsr_gat, "gat_bwd_dad", lambda f: lambda *a, **k: f(*a, **k) * (1 - 2.0**-7)),
    }
    for label, (module, name, wrap) in faults.items():
        gat = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=h0.device)
        with patched(module, name, wrap):
            softmax_xent(gat(agg, h0, fast=False, stabilize="bound", dot_mode="default"), train["labels"]).backward()
        grads = [(p.w.grad.detach(), p.w_att.grad.detach()) for p in gat.layer_params()]
        rels = grad_readings(grads, train["chain"], f"planted fault ({label}): 'default' GAT")
        readings[label] = max(max(r) for r in rels)
        check(readings[label] > GRAD_REL_L2, f"planted fault ({label}) passes the gradient bound")
    sound = max(max(r) for r in train["rel_l2"])
    log(f"  gradient bound {GRAD_REL_L2:g}: sound step's largest relative L2 {sound:.3e}, planted faults "
        + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()))
    return dict(sound=sound, **readings)


def residual_identities(tp, plan, h, what: str) -> dict:
    """P1 and P2 over ``tp`` and ``plan`` at h's width, each called twice
    (bitwise equal): P2's dense_out bitwise B1's output (bcsr_spmm_cuda over x, h rounded to
    'split' and times scale_src, as the probe hands it to P2) times
    scale_dst, its task sums bitwise P1's; both within KERNEL_TOL *
    max|plain| of their plain versions.  Returns each output's max|d|."""
    x = _pre_scale(tp, round_h(h, "split")).contiguous()
    ts = twice_equal(lambda: cuda_residual.task_sums_cuda(plan, h), f"{what} P1")
    b1 = _post_scale(tp, cuda_bcsr.bcsr_spmm_cuda(tp, x))
    dense, ts2 = twice_equal(lambda: cuda_residual.fused_hybrid_cuda(tp, plan, x, h), f"{what} P2")
    check(torch.equal(dense, b1), f"{what}: P2's dense_out is not bitwise B1's output times scale_dst")
    check(torch.equal(ts2, ts), f"{what}: P2's task sums are not bitwise P1's")
    log(f"  {what} f={h.shape[1]}: P1 and P2 twice bitwise equal; P2's dense_out bitwise B1 x scale_dst, its "
        f"task sums bitwise P1's")
    want_dense, want_ts = probe.fused_hybrid_plain(tp, plan, h)
    return {k: compare(got, want, f"{what} {k} vs its plain version", gate=False)
            for k, got, want in (("P1", ts, want_ts), ("P2 dense_out", dense, want_dense),
                                 ("P2 task sums", ts2, want_ts))}


def two_clocks(fn, expect=()) -> dict:
    """ms by CUDA events (a call's host-side launch included) and the
    profiler's device ms, summed and by kernel."""
    per = device_ms(fn, expect=expect)
    return dict(ms=cuda_time_ms(fn), device_ms=None if per is None else per["all"], device_kernels=per)


def probe_phase(g, gen) -> dict:
    """Phase 36: the residual-DMA probe at --small size (the quick graph,
    65,536 nodes, 4,194,304 edges, f = 128).  The probe plan's work list
    printed; P1 and P2 twice (bitwise equal), P2's dense_out
    bitwise B1's times scale_dst and its task sums bitwise P1's, both
    against their plain versions (residual_identities) over the probe plan,
    the plan skewed as phase 37 skews plans (also at f = 160: the walk's
    f-slices) and a factored plan of the same graph; the probe's two modes
    through its own measure() (launches counted); then the times, by CUDA
    events and as device time, of P1, embedding_bag (the library
    yardstick), the plain residual, P2 (its walk alone, its finish pass and
    what the residual blocks add), B1, B1 then P1 and B1 then spmm_plain."""
    dev = gen.device
    log("phase 36: the residual-DMA probe (P1 task sums, P2 fused hybrid on the cell walk), --small")
    t0 = time.perf_counter()
    agg = probe.schedule(g, dev)
    plan, tp = agg.plan, agg.tile
    nt, blk = plan.num_tasks_padded, plan.block_size
    slots = nt * blk
    log(f"  probe plan: int8 [256, 128] t24 tiles={tp.num_tiles} residual edges={plan.num_edges} tasks={nt} "
        f"slots={slots} (block {blk}); built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(36)
    sd = rng.uniform(0.2, 2.0, g.num_nodes).astype(np.float32)
    ss = rng.uniform(0.2, 2.0, g.n_src).astype(np.float32)
    kw = {k: v for k, v in probe.SCHEDULE.items() if k != "residual_block"}
    fac_host, fac_res = densify(g, dtype=np.int8, val=sd[g.dst_per_edge] * ss[g.indices], scale_dst=sd, scale_src=ss,
                                **kw)
    plans = {
        "probe int8 [256, 128] t24": (tp, plan),
        "its skewed form": (skewed(tp), plan),
        "factored int8 [256, 128] t24": (fac_host.to(dev),
                                         neighbor_grouping_plan(fac_res, block_size=probe.SCHEDULE["residual_block"]).to(dev)),
    }
    del fac_host, fac_res
    walks = [walk_line(p, label) for label, (p, _) in plans.items()]
    h = torch.from_numpy(normal_features(g.num_nodes, PROBE_F, seed=1) * 0.1).to(dev)
    with torch.no_grad():
        err = {}
        for label, (p, rp) in plans.items():
            for f in ((PROBE_F, 160) if label == "its skewed form" else (PROBE_F,)):
                hf = h if f == PROBE_F else torch.randn((g.n_src, f), generator=gen, device=dev) * 0.1
                for k, v in residual_identities(p, rp, hf, f"{label}").items():
                    err[k] = max(err.get(k, 0.0), v)
        del plans
        src2, val2 = plan.src.view(nt, blk), plan.val.view(nt, blk)
        lib = torch.nn.functional.embedding_bag(src2, h, per_sample_weights=val2, mode="sum")
        compare(lib, weighted_task_sums(plan, h, plan.val), "embedding_bag (the yardstick) vs weighted_task_sums",
                gate=False)
        runs = {}
        for mode in ("standalone", "fused"):
            reset_counts()
            runs[mode] = probe.measure(agg, h, mode)
            runs[mode]["launches"] = counts()
            log(f"  probe --mode {mode}: {json.dumps(runs[mode])}")
            check(runs[mode]["error"]["max_abs_over_max_ref"] <= KERNEL_TOL, f"probe --mode {mode}: off the plain pass")
        check(runs["standalone"]["launches"]["P1"] > 0 and runs["fused"]["launches"]["P2"] > 0,
              "the probe's path did not launch P1 / P2")
        b1_bytes = tp.a.numel() * tp.a.element_size() + 4 * (tp.num_tiles + tp.num_row_tiles + 1) \
            + 4 * PROBE_F * (tp.n_src + tp.num_nodes)
        # P1 reads each distinct source row the slots gather once (a row
        # that many slots gather is read once; the 50 MB L2 holds repeats;
        # pad slots read row 0), int32 indices and float32 values a slot,
        # and writes the task sums once
        distinct = torch.unique(plan.src).numel()
        log(f"  distinct source rows gathered: {distinct} of {plan.n_src} (slots {slots})")
        p1_bytes = distinct * PROBE_F * 4 + slots * 8 + nt * PROBE_F * 4
        c_cnt = tile_cells(tp)[2]
        x = round_h(h, "split").contiguous()
        no_tasks = dataclasses.replace(plan, src=plan.src[:0], val=plan.val[:0])
        p1 = lambda: cuda_residual.task_sums_cuda(plan, h)  # noqa: E731
        p2 = lambda: cuda_residual.fused_hybrid_cuda(tp, plan, x, h)  # noqa: E731
        b1 = lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x)  # noqa: E731
        # B1 walks the plan's staged chunks with stage_kernel where it stages them, any others with walk_kernel
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        staging = cell_walk.stageable(tp) and cell_walk.stages(cell_walk.walk_for(tp), PROBE_F, sms)
        b1_kernel = ("stage_kernel",) if staging else ("walk_kernel",)
        t = dict(
            P1=two_clocks(p1, expect=("task_sums_kernel",)),
            P1_plain=two_clocks(lambda: weighted_task_sums(plan, h, plan.val)),
            embedding_bag=two_clocks(
                lambda: torch.nn.functional.embedding_bag(src2, h, per_sample_weights=val2, mode="sum")
            ),
            residual_spmm_plain=two_clocks(lambda: spmm_plain(plan, h)),
            P2_plain=two_clocks(lambda: probe.fused_hybrid_plain(tp, plan, h)),
            B1=two_clocks(b1, expect=b1_kernel),
            B1_then_P1=two_clocks(lambda: (b1(), p1()), expect=b1_kernel + ("task_sums_kernel",)),
            B1_then_spmm_plain=two_clocks(lambda: (b1(), spmm_plain(plan, h))),
        )
        t["P2"] = two_clocks(p2, expect=("fused_hybrid_kernel",))
        t["P2_walk_only"] = two_clocks(lambda: cuda_residual.fused_hybrid_cuda(tp, no_tasks, x, h),
                                       expect=("fused_hybrid_kernel",))
    p1_bound = bound(p1_bytes, 2.0 * slots * PROBE_F)
    p2_bound = bound(b1_bytes + p1_bytes, 2.0 * (c_cnt.numel() + slots) * PROBE_F)

    def dev_txt(r, kernel=None):
        per = r["device_kernels"]
        if per is None or (kernel is not None and kernel not in per):
            return "not measured"
        return f"{per[kernel if kernel else 'all']:.4f}"

    log(f"  P1 {t['P1']['ms']:.4f} ms, device {dev_txt(t['P1'])} ({t['P1']['ms'] / slots * 1e6:.3f} ns/slot) bound "
        f"{p1_bound['bound_ms']:.4f} | plain {t['P1_plain']['ms']:.4f} | embedding_bag {t['embedding_bag']['ms']:.4f} "
        f"(device {dev_txt(t['embedding_bag'])}) | residual spmm_plain {t['residual_spmm_plain']['ms']:.4f}")
    full, walk_only = t["P2"], t["P2_walk_only"]
    log(f"  P2 {full['ms']:.4f} ms, device {dev_txt(full)}: its kernel {dev_txt(full, 'fused_hybrid_kernel')} "
        f"(walk blocks alone {dev_txt(walk_only, 'fused_hybrid_kernel')}), finish pass "
        f"{dev_txt(full, 'finish_kernel')}; bound {p2_bound['bound_ms']:.4f}")
    log(f"  P2 plain {t['P2_plain']['ms']:.4f} | B1 {t['B1']['ms']:.4f} (device {dev_txt(t['B1'])}), B1 then P1 "
        f"{t['B1_then_P1']['ms']:.4f} (device {dev_txt(t['B1_then_P1'])}), B1 then spmm_plain "
        f"{t['B1_then_spmm_plain']['ms']:.4f}")
    return dict(err=err, times=t, runs=runs, p1_bound=p1_bound, p2_bound=p2_bound, slots=slots, tasks=nt,
                tiles=tp.num_tiles, distinct_rows=distinct, walks=walks)


def mode_kernel_entries(modes: dict, pr: dict, libs: dict) -> list:
    """The kernels-line entries of phases 34-36: B2 'default', 'twodot' and
    'merged' (times summed over the three layers of one forward over the
    GAT plan, int8 [512, 256] t32; the 1-bit part's and G1's beside them),
    P1 and P2 (the probe's plan, f = 128)."""
    rows = modes["rows"]
    int8 = rows["GAT int8 [512, 256] t32"]

    def total(rs, k):
        return sum(r[k] for r in rs)

    b2 = dict(bound_ms=total(int8, "bound_ms"), library_ms=total(int8, "library_ms"),
              bound_by="bytes" if all(r["bound_by"] == "bytes" for r in int8) else "operations")
    others = {label: {k: total(rs, k) for k in rs[0] if k.endswith("_ms") and k != "bound_ms"}
              for label, rs in rows.items() if rs is not int8}
    src = "gnn_computing_tpu_torch/csrc/"
    ablation = "Figure 10a's ablation path: gat_bcsr_tiles over the GAT plan's tiles, one call a layer of the 3-layer forward"
    t = pr["times"]
    runs = pr["runs"]
    return [
        dict(name="gat_bcsr_default", route="cuda", walk="cell", source=src + "gat_bcsr.cu",
             replaces="gnn_computing_tpu/ops/pallas_bcsr.py:668", launches=modes["forward_counts"]["B2_default"],
             launches_per_forward=3, training_launches=modes["train_counts"]["B2"],
             max_abs_err=modes["max_err"]["default"], ms=total(int8, "default_ms"),
             plain_ms=total(int8, "default_plain_ms"), **b2, maxdot_ms=total(int8, "maxdot_ms"),
             path="bench.py --model gat --gat-dot-mode default (fast, GAT plan int8 [512, 256] t32), 5 forwards; "
                  f"--train --model gat --gat-dot-mode default (stabilize 'bound'), {TRAIN_STEPS} steps",
             forward_ms=modes["times"]["default_forward_ms"], split2_forward_ms=modes["times"]["split2_forward_ms"],
             step_ms=modes["times"]["default_step_ms"], off_gate_share=modes["off_share"],
             train_rel_l2=modes["train_rel_l2"], other_plans=others, build_s=libs["gat_bcsr"][1]),
        dict(name="gat_bcsr_twodot", route="cuda", walk="cell", source=src + "gat_bcsr_factored.cu",
             replaces="gnn_computing_tpu/ops/pallas_bcsr.py:792", launches=modes["ablation"]["B2_twodot"],
             launches_per_pass=3, max_abs_err=modes["max_err"]["twodot"], ms=total(int8, "twodot2_ms"),
             plain_ms=total(int8, "twodot2_plain_ms"), **b2, hv_chunks=2, hv1_ms=total(int8, "twodot1_ms"),
             entry_ms=total(int8, "twodot2_entry_ms"), maxdot_ms=total(int8, "maxdot_ms"), path=ablation,
             wide_rescued=modes["wide"], other_plans=others, build_s=libs["gat_bcsr_factored"][1]),
        dict(name="gat_bcsr_merged", route="cuda", walk="cell", source=src + "gat_bcsr_factored.cu",
             replaces="gnn_computing_tpu/ops/pallas_bcsr.py:724", launches=modes["ablation"]["B2_merged"],
             launches_per_pass=3, max_abs_err=modes["max_err"]["merged"], ms=total(int8, "merged2_ms"),
             plain_ms=total(int8, "merged2_plain_ms"), **b2, hv_chunks=2, hv1_ms=total(int8, "merged1_ms"),
             entry_ms=total(int8, "merged2_entry_ms"), maxdot_ms=total(int8, "maxdot_ms"), path=ablation,
             other_plans=others, build_s=libs["gat_bcsr_factored"][1]),
        dict(name="task_sums", route="cuda", source=src + "task_sums.cu",
             replaces="probes/overlap_dma_residual.py:40", launches=runs["standalone"]["launches"]["P1"],
             max_abs_err=pr["err"]["P1"], ms=t["P1"]["ms"], device_ms=t["P1"]["device_ms"],
             plain_ms=t["P1_plain"]["ms"], **pr["p1_bound"], library_ms=t["embedding_bag"]["ms"],
             library_device_ms=t["embedding_bag"]["device_ms"], residual_spmm_plain_ms=t["residual_spmm_plain"]["ms"],
             slots=pr["slots"], tasks=pr["tasks"], distinct_rows=pr["distinct_rows"],
             path=f"the residual probe --small --mode standalone (int8 [256, 128] t24, residual 4, f={PROBE_F})",
             build_s=libs["task_sums"][1]),
        dict(name="fused_hybrid", route="cuda", walk="cell", source=src + "fused_hybrid.cu",
             replaces="probes/overlap_dma_residual.py:127", launches=runs["fused"]["launches"]["P2"],
             max_abs_err=max(pr["err"]["P2 dense_out"], pr["err"]["P2 task sums"]), ms=t["P2"]["ms"],
             device_ms=t["P2"]["device_ms"], plain_ms=t["P2_plain"]["ms"], **pr["p2_bound"], library_ms=None,
             b1_ms=t["B1"]["ms"], b1_device_ms=t["B1"]["device_ms"], b1_then_p1_ms=t["B1_then_P1"]["ms"],
             b1_then_p1_device_ms=t["B1_then_P1"]["device_ms"], b1_then_spmm_plain_ms=t["B1_then_spmm_plain"]["ms"],
             device_kernels=t["P2"]["device_kernels"], walk_only=t["P2_walk_only"], walk_plans=pr["walks"], fused_pass_ms=runs["fused"]["fused_ms"],
             sequential_pass_ms=runs["fused"]["sequential_ms"], tiles=pr["tiles"],
             path=f"the residual probe --small --mode fused (int8 [256, 128] t24, residual 4, f={PROBE_F}, split)",
             build_s=libs["fused_hybrid"][1]),
    ]


# ------------------------------------------------ phase 37 (the cell walk)
def walk_line(tp, label: str) -> dict:
    """Logs and returns the plan's cell-walk work list (ops/cell_walk.py):
    its chunks, the runs cut into several, the largest chunk in nonzero
    cells and the scratch bytes of its multi-chunk runs at f = 128 (B1 and
    B2 maxdot one branch, B3 as B2, twodot two)."""
    w = cell_walk.walk_for(tp)
    d = dict(plan=label, format=tp.format, tiles=tp.num_tiles, runs=tp.num_row_tiles, chunks=w.num_chunks,
             multi_runs=w.num_multi, slots=w.num_slots, bound=w.bound, cells=w.total_cells,
             max_chunk_cells=w.max_chunk_cells,
             scratch_bytes=dict(B1=w.scratch_bytes(tp.tile_rows, 128),
                                B2=w.scratch_bytes(tp.tile_rows, 128, den=True),
                                twodot=w.scratch_bytes(tp.tile_rows, 128, nb=2, den=True)))
    log(f"  cell walk, {label}: {w.num_chunks} chunks "
        f"over {tp.num_row_tiles} runs ({w.num_multi} runs cut, {w.num_slots} scratch slots), bound {w.bound} cells, "
        f"largest chunk {w.max_chunk_cells} of {w.total_cells} cells; scratch at f=128: "
        f"B1 {d['scratch_bytes']['B1']} B, B2 {d['scratch_bytes']['B2']} B, twodot {d['scratch_bytes']['twodot']} B")
    return d


def skewed(tp):
    """The plan with every tile in run 0 and one all-ones tile row (row 0 of
    tile 0; for a 1-bit plan bit plane 0 of its byte row 0)."""
    a = tp.a.clone()
    a[0, 0, :] = 1
    nrt = tp.num_row_tiles
    return dataclasses.replace(
        tp, a=a, tile_row=torch.zeros_like(tp.tile_row),
        run_start=torch.tensor([0] + [tp.num_tiles] * nrt, dtype=torch.int32, device=tp.a.device),
    )


def twice_equal(fn, what: str):
    """fn() twice on the card: the results bitwise equal (the walk sums its
    chunks in a fixed order, without atomics)."""
    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(first, second)), f"{what}: two calls differ")
    return first if len(first) > 1 else first[0]


def walk_kernels_vs_plain(tp, gen, what: str, f: int = BENCH_DIMS[1]) -> float:
    """B1, its w_epilogue and B2 in every mode over ``tp`` at width f,
    each called twice (bitwise equal) and held to its plain version
    (KERNEL_TOL; 'default' through default_vs_plain).  Returns the largest
    max|d| / max|plain|."""
    err = 0.0
    h = torch.randn((tp.n_src, f), generator=gen, device="cuda")
    got = twice_equal(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h), f"{what} B1")
    want = bcsr_spmm_plain(tp, h)
    err = max(err, compare(got, want, f"{what} B1 f={f}", gate=False) / want.abs().max().item())
    w = torch.randn((f, BENCH_DIMS[2]), generator=gen, device="cuda") * 0.1
    agg, trans = twice_equal(lambda: bcsr_spmm_nn(tp, h, w), f"{what} B1 w_epilogue")
    want_agg, want_trans = bcsr_spmm_nn_plain(tp, h, w)
    compare(agg, want_agg, f"{what} B1 w_epilogue agg", gate=False)
    compare(trans, want_trans, f"{what} B1 w_epilogue trans", gate=False)
    att = torch.randn((tp.num_nodes, 2), generator=gen, device="cuda") * 0.3
    for shift in (None, _resolve_shift(tp, None, att, DEFAULT_SLOPE, True)):
        label = f"{what} f={f}{' shifted' if shift is not None else ''}"
        num, den = twice_equal(lambda: gat_bcsr(tp, h, att, row_shift=shift, dot_mode="split2"), f"{label} B2")
        ref_num, ref_den = gat_bcsr_plain(tp, h, att, row_shift=shift)
        err = max(err, compare(num, ref_num, f"{label} B2 maxdot num", gate=False) / ref_num.abs().max().item())
        compare(den, ref_den, f"{label} B2 maxdot den", gate=True)
        twice_equal(lambda: gat_bcsr(tp, h, att, row_shift=shift, dot_mode="default"), f"{label} B2 default")
        default_vs_plain(tp, h, att, shift, label)
        for mode in ("twodot", "merged"):
            twice_equal(lambda: gat_bcsr_factored(tp, h, att, DEFAULT_SLOPE, mode, 2, shift)[:2], f"{label} {mode}")
            factored_vs_plain(tp, h, att, shift, mode, 2, label)
    return err


def walk_phase(g, gen) -> dict:
    """Phase 37: the cell walk of B1 and B2 at the main plans' shapes.  Each
    main plan's work list is printed (walk_line).  Repeat: on the GCN and
    GAT int8 plans, the training plan's transposed 1-bit part and G1's
    float32 plan, B1, its w_epilogue and B2 in every mode twice, bitwise
    equal, and against their plain versions.  Skew: the GCN plan and G1's
    plan with every tile in one run and one all-ones tile row (skewed), the
    same checks.  Balance: B1's time over the GCN plan by chunk bound."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gcn_host = densify(g, dtype=np.int8, **SCHEDULE)[0]
    train_host = densify(g, dtype=np.int8, **TRAIN_SCHEDULE)[0]
    plans = {
        "GCN int8 [512, 256] t48": gcn_host.to(dev),
        "its 1-bit part": split_bit_tiles(gcn_host)[0].to(dev),
        "GAT int8 [512, 256] t32": densify(g, dtype=np.int8, **GAT_SCHEDULE)[0].to(dev),
        "training [256, 256] t24, transposed": train_host.transpose().to(dev),
        "its 1-bit part, transposed": split_bit_tiles(train_host)[0].transpose().to(dev),
        "G1 float32 [256, 128]": Aggregator.schedule_hybrid(g, pack=1, with_transpose=False, device=dev).tile,
    }
    del gcn_host, train_host
    log(f"phase 37: the cell walk (plans built in {time.perf_counter() - t0:.1f} s)")
    stats = [walk_line(tp, label) for label, tp in plans.items()]
    max_err = 0.0
    with torch.no_grad():
        for label in ("GCN int8 [512, 256] t48", "GAT int8 [512, 256] t32", "its 1-bit part, transposed",
                      "G1 float32 [256, 128]"):
            max_err = max(max_err, walk_kernels_vs_plain(plans[label], gen, label))
        for label in ("GCN int8 [512, 256] t48", "G1 float32 [256, 128]"):
            sk = skewed(plans[label])
            stats.append(walk_line(sk, f"{label}, skewed"))
            check(cell_walk.walk_for(sk).num_multi == 1, f"{label}, skewed: its one run was not cut into chunks")
            max_err = max(max_err, walk_kernels_vs_plain(sk, gen, f"{label}, skewed"))
            del sk
        # the run balance: B1 over the GCN plan with its runs cut finer,
        # as they are, and not at all (a bound above its largest run)
        tp = plans["GCN int8 [512, 256] t48"]
        h = torch.randn((tp.n_src, BENCH_DIMS[1]), generator=gen, device="cuda")
        sweep = {}
        for bound in (1 << 14, cell_walk.MIN_BOUND, 1 << 20):
            default = cell_walk.MIN_BOUND
            cell_walk.MIN_BOUND = bound
            try:
                w = cell_walk.walk_for(tp)
                sweep[bound] = dict(chunks=w.num_chunks, runs_cut=w.num_multi,
                                    ms=cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h)))
            finally:
                cell_walk.MIN_BOUND = default
        log("  B1 over the GCN plan, f=128, by chunk bound: "
            + "; ".join(f"{b} cells: {v['chunks']} chunks, {v['runs_cut']} runs cut, {v['ms']:.3f} ms"
                        for b, v in sweep.items()))
    log(f"  phase 37: every call twice bitwise equal; max|d|/max|plain| {max_err:.3e}")
    return dict(plans=stats, max_err=max_err, bound_sweep=sweep)


# ------------------------------------------------ phase 38 (B3 and B5 on the cell walk)
def rowmax_vs_plain(tp, gen, what: str):
    """B5 over ``tp`` twice (bitwise equal), equal to its plain version, at
    att scales 1 and 15."""
    for scale in (1.0, 15.0):
        vals = torch.randn(tp.n_src, generator=gen, device="cuda") * scale
        got = twice_equal(lambda: cuda_rowmax.rowmax_bcsr_cuda(tp, vals), f"{what} B5")
        check(torch.equal(got, bcsr_rowmax_plain(tp, vals)), f"{what} B5 differs from bcsr_rowmax_plain")


def dad_vs_plain(tp, gen, what: str, fs=BENCH_DIMS[1:]) -> float:
    """B3 over ``tp`` twice (bitwise equal) and within KERNEL_TOL *
    max|plain| of its plain version at each f, att at scale 0.1 unshifted
    and at scale 15 with the 'bound' shift.  Returns the largest max|d| /
    max|plain|."""
    err = 0.0
    for f in fs:
        for scale, shift in ((0.1, False), (15.0, True)):
            args = bwd_inputs(tp.num_nodes, f, scale, shift, gen, tp.a.device) + (DEFAULT_SLOPE,)
            got = twice_equal(lambda: cuda_gat_bwd.gat_bwd_dad_cuda(tp, *args), f"{what} B3 f={f}")
            want = gat_bwd_dad_plain(tp, *args)
            label = f"{what} B3 f={f} scale {scale}{' bound-shifted' if shift else ''}"
            err = max(err, compare(got, want, label, gate=False) / want.abs().max().item())
    return err


def rowmax_dad_phase(g, gen) -> dict:
    """Phase 38: B3 and B5 on the cell walk.  Each plan B5 runs on (the GAT
    plan and its 1-bit and int8 parts, G1, G2) and B3 runs on (the training
    plan and its parts, T over float32 and bfloat16): its work list, each
    kernel twice (bitwise equal) and against its plain version (B5 equal,
    B3 within KERNEL_TOL * max|plain|); the same on phase 37's skewed
    plans.  Then B5's time on each of its plans and B3's on each of its at
    f = 128, by CUDA events and as device time alone."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gat_host = densify(g, dtype=np.int8, **GAT_SCHEDULE)[0]
    train_host = densify(g, dtype=np.int8, **TRAIN_SCHEDULE)[0]
    t_f32 = densify(g, dtype=np.float32, **TRAIN_SCHEDULE)[0].to(dev)
    b5_plans = {"GAT int8 [512, 256] t32": gat_host.to(dev)}
    b5_plans["its 1-bit part"], b5_plans["its int8 part"] = (p.to(dev) for p in split_bit_tiles(gat_host))
    b5_plans["G1 float32 [256, 128]"] = Aggregator.schedule_hybrid(g, pack=1, with_transpose=False, device=dev).tile
    b5_plans["G2 bfloat16 [512, 256] t32"] = b5_plans["GAT int8 [512, 256] t32"].astype(torch.bfloat16)
    b3_plans = {"training int8 [256, 256] t24": train_host.to(dev)}
    b3_plans["its 1-bit part"], b3_plans["its int8 part"] = (p.to(dev) for p in split_bit_tiles(train_host))
    b3_plans["T float32 [256, 256] t24"] = t_f32
    b3_plans["T bfloat16 [256, 256] t24"] = t_f32.astype(torch.bfloat16)
    gcn = densify(g, dtype=np.int8, **SCHEDULE)[0].to(dev)
    del gat_host, train_host
    log(f"phase 38: B3 and B5 on the cell walk (plans built in {time.perf_counter() - t0:.1f} s)")
    stats = dict(B5=[walk_line(tp, label) for label, tp in b5_plans.items()],
                 B3=[walk_line(tp, label) for label, tp in b3_plans.items()])
    max_err = 0.0
    with torch.no_grad():
        for label, tp in b5_plans.items():
            rowmax_vs_plain(tp, gen, label)
        for label, tp in b3_plans.items():
            max_err = max(max_err, dad_vs_plain(tp, gen, label))
        for label, tp in (("GCN int8 [512, 256] t48", gcn), ("G1 float32 [256, 128]", b5_plans["G1 float32 [256, 128]"])):
            sk = skewed(tp)
            label = f"{label}, skewed"
            stats["B5"].append(walk_line(sk, label))
            stats["B3"].append(walk_line(sk, label))
            check(cell_walk.walk_for(sk).num_multi == 1, f"{label}: its one run was not cut")
            rowmax_vs_plain(sk, gen, label)
            check(bool(torch.isneginf(bcsr_rowmax_plain(sk, sk.a.new_zeros(sk.n_src, dtype=torch.float32))).any()),
                  f"{label}: no row without a cell")
            max_err = max(max_err, dad_vs_plain(sk, gen, label, fs=(BENCH_DIMS[1], 160)))
            del sk
        log(f"  phase 38 checks: every call twice bitwise equal; B5 equal to plain; B3 max|d|/max|plain| {max_err:.3e}")

        # one reading a plan: ms by CUDA events (a call's host-side launch
        # included), device_ms the profiler's kernel time alone
        f = BENCH_DIMS[1]
        timed = {}
        for label, tp in b5_plans.items():
            asrc = torch.randn(tp.n_src, generator=gen, device=dev)
            timed[f"B5 {label}"] = lambda tp=tp, asrc=asrc: cuda_rowmax.rowmax_bcsr_cuda(tp, asrc)
        for label, tp in b3_plans.items():
            bwd = bwd_inputs(tp.num_nodes, f, 1.0, True, gen, dev) + (DEFAULT_SLOPE,)
            timed[f"B3 {label} f={f}"] = lambda tp=tp, bwd=bwd: cuda_gat_bwd.gat_bwd_dad_cuda(tp, *bwd)
        times = {}
        for k, fn in timed.items():
            times[k] = two_clocks(fn)
            per = times[k]["device_kernels"]
            log(f"  {k}: {times[k]['ms']:.3f} ms (device "
                + ("not measured" if per is None else f"{per['all']:.3f}: {json.dumps(per)}") + ")")
    return dict(plans=stats, max_err=max_err, times=times)


# ------------------------------------------------ phase 39 (B4 on the cell walk, B6 streamed)
def dh_das_vs_plain(tp_t, gen, what: str, fs=(128, 64, 32, 160)) -> float:
    """B4 over the transposed plan ``tp_t`` twice (bitwise equal) and dh and
    d_as each within KERNEL_TOL * max|plain| of its plain version at each f,
    att at scale 0.1 unshifted and at 15 with the 'bound' shift.  Returns
    the largest max|d| / max|plain|."""
    check(tp_t.num_nodes == tp_t.n_src, f"{what}: B4's checks take a square plan")
    err = 0.0
    for f in fs:
        for scale, shift in ((0.1, False), (15.0, True)):
            args = bwd_inputs(tp_t.num_nodes, f, scale, shift, gen, tp_t.a.device) + (DEFAULT_SLOPE,)
            dh, das = twice_equal(lambda: cuda_gat_bwd.gat_bwd_dh_das_cuda(tp_t, *args), f"{what} B4 f={f}")
            want_dh, want_das = gat_bwd_dh_das_plain(tp_t, *args)
            label = f"{what} B4 f={f} scale {scale}{' bound-shifted' if shift else ''}"
            err = max(err, compare(dh, want_dh, f"{label} dh", gate=False) / want_dh.abs().max().item(),
                      compare(das, want_das, f"{label} d_as", gate=False) / want_das.abs().max().item())
    return err


def sddmm_twice_vs_plain(tp, gen, what: str, fs=(SDDMM_F, BENCH_DIMS[1])) -> float:
    """B6 over ``tp`` twice (bitwise equal) in float32 and bfloat16 cells,
    held to sddmm_bcsr_plain with phase 29's tolerances (cells_agree: float32
    within KERNEL_TOL * max|plain|, bfloat16 within one ulp, cells whose value
    is not > 0 exactly +0), CHECK_TILES tiles at a time.  Returns the largest
    float32 max|d| / max|plain|."""
    err = 0.0
    for f in fs:
        a = torch.randn((tp.n_src, f), generator=gen, device="cuda")
        b = torch.randn((tp.num_nodes, f), generator=gen, device="cuda")
        for s in range(0, tp.num_tiles, CHECK_TILES):
            sub = tile_slice(tp, s, s + CHECK_TILES)
            edge = sub.counts() > 0
            for out in (torch.float32, torch.bfloat16):
                got = twice_equal(lambda: cuda_sddmm.sddmm_bcsr_cuda(sub, a, b, out), f"{what} B6 f={f} {out}")
                want = sddmm_bcsr_plain(sub, a, b, out)
                e = cells_agree(got, want, edge, f"{what} B6 f={f} {out}")
                if out == torch.float32:
                    err = max(err, e / max(want.abs().max().item(), 1e-30))
                del got, want
        log(f"  {what} B6 f={f}: tiles={tp.num_tiles}, twice bitwise equal, within phase 29's tolerances")
    return err


def profile_table(fn, iters: int = 3) -> str:
    """torch.profiler's table (host and device time by operator) over
    ``iters`` calls of fn after one warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cpu_time_total", row_limit=14, max_name_column_width=48)


def dh_das_sddmm_phase(g, gen) -> dict:
    """Phase 39: B4 and B6 redesigned.  B4's work lists (the transposed
    plans' own) over every plan it runs on (the training plan's transpose,
    its 1-bit and int8 parts', T's float32 and bfloat16 transposes) and B6's
    one block a tile over its plans (the SDDMM path's two parts, G1,
    gcn_norm_val, G2); each kernel twice (bitwise equal) against its plain
    version; the same on phase 37's skewed plans.  Then B4 at f = 128, 64,
    32 and B6 at f = 32 on each plan by CUDA events and as device time per
    kernel (walk, finish, dot apart), and the updateval chain with the
    weighted plan's list shared and rebuilt every call (the earlier path),
    with a profiler table of each."""
    dev = torch.device("cuda")
    n = g.num_nodes
    t0 = time.perf_counter()
    train_host = densify(g, dtype=np.int8, **TRAIN_SCHEDULE)[0]
    t_f32 = densify(g, dtype=np.float32, **TRAIN_SCHEDULE)[0]
    b4_plans = {"training [256, 256] t24, transposed": train_host.transpose().to(dev)}
    bits, ints = split_bit_tiles(train_host)
    b4_plans["its 1-bit part, transposed"] = bits.transpose().to(dev)
    b4_plans["its int8 part, transposed"] = ints.transpose().to(dev)
    b4_plans["T float32, transposed"] = t_f32.transpose().to(dev)
    b4_plans["T bfloat16, transposed"] = b4_plans["T float32, transposed"].astype(torch.bfloat16)
    sagg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                      pack=1, bit_tiles=True, device=dev, **SDDMM_SCHEDULE)
    parts = sagg.tile_parts()
    b6_plans = {f"SDDMM [256, 128] t24, {part_name(p)} part": p for p in parts}
    b6_plans["G1 float32 [256, 128]"] = Aggregator.schedule_hybrid(g, pack=1, with_transpose=False, device=dev).tile
    b6_plans["gcn_norm_val float32 [512, 256] t48"] = densify(g, val=g.gcn_norm_val(), **SCHEDULE)[0].to(dev)
    b6_plans["G2 bfloat16 [512, 256] t32"] = densify(g, dtype=torch.bfloat16, **GAT_SCHEDULE)[0].to(dev)
    gcn = densify(g, dtype=np.int8, **SCHEDULE)[0].to(dev)
    del train_host, t_f32, bits, ints
    log(f"phase 39: B4 on the cell walk, B6 streamed (plans built in {time.perf_counter() - t0:.1f} s)")
    stats = dict(B4=[walk_line(tp, label) for label, tp in b4_plans.items()], B6=[])
    for label, tp in b6_plans.items():
        cells = int(cell_walk.tile_nnz(tp).sum())
        stats["B6"].append(dict(plan=label, format=tp.format, tiles=tp.num_tiles, blocks=tp.num_tiles, cells=cells,
                                out_cells=tp.num_tiles * tp.tile_rows * tp.tile_cols))
        log(f"  B6, {label}: no work list, one block a tile: {tp.num_tiles} blocks over "
            f"{tp.num_tiles * tp.tile_rows * tp.tile_cols} cells, {cells} nonzero")
    max_err = dict(B4=0.0, B6=0.0)
    with torch.no_grad():
        for label, tp in b4_plans.items():
            max_err["B4"] = max(max_err["B4"], dh_das_vs_plain(tp, gen, label))
        for label, tp in b6_plans.items():
            max_err["B6"] = max(max_err["B6"], sddmm_twice_vs_plain(tp, gen, label))
        for label, tp in (("GCN int8 [512, 256] t48", gcn), ("G1 float32 [256, 128]", b6_plans["G1 float32 [256, 128]"])):
            sk = skewed(tp)
            label = f"{label}, skewed"
            stats["B4"].append(walk_line(sk, label))
            check(cell_walk.walk_for(sk).num_multi == 1, f"{label}: its one run was not cut")
            max_err["B4"] = max(max_err["B4"], dh_das_vs_plain(sk, gen, label, fs=(BENCH_DIMS[1], 160)))
            max_err["B6"] = max(max_err["B6"], sddmm_twice_vs_plain(sk, gen, label, fs=(SDDMM_F,)))
            del sk
        log(f"  phase 39 checks: every call twice bitwise equal; B4 max|d|/max|plain| {max_err['B4']:.3e}, "
            f"B6 float32 {max_err['B6']:.3e}")

        # one reading a plan: ms by CUDA events (a call's host-side launch
        # included), device_ms the profiler's kernel time alone, by kernel
        timed = {}
        for label, tp in b4_plans.items():
            for f in BENCH_DIMS[1:]:
                bwd = bwd_inputs(tp.num_nodes, f, 1.0, True, gen, dev) + (DEFAULT_SLOPE,)
                timed[f"B4 {label} f={f}"] = lambda tp=tp, bwd=bwd: cuda_gat_bwd.gat_bwd_dh_das_cuda(tp, *bwd)
        for label, tp in b6_plans.items():
            a = torch.randn((tp.n_src, SDDMM_F), generator=gen, device=dev)
            b = torch.randn((tp.num_nodes, SDDMM_F), generator=gen, device=dev)
            timed[f"B6 {label} f={SDDMM_F}"] = lambda tp=tp, a=a, b=b: cuda_sddmm.sddmm_bcsr_cuda(tp, a, b)
        times = {}
        for k, fn in timed.items():
            times[k] = two_clocks(fn, expect=("walk_kernel", "dot_kernel") if k.startswith("B4") else ("sddmm_bcsr_kernel",))
            per = times[k]["device_kernels"]
            log(f"  {k}: {times[k]['ms']:.3f} ms (device "
                + ("not measured" if per is None else f"{per['all']:.3f}: {json.dumps(per)}") + ")")

        # the updateval chain (phase 26's path): the weighted plans walk the
        # count plans' lists (shared), or build their own at every call, as
        # the chain did before share_walk
        a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
        b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
        hc = torch.from_numpy(normal_features(n, SDDMM_F, seed=5)).to(dev)

        def chain():
            cells, _ = hybrid_sddmm(parts, None, a, b, out_dtype=torch.float32, dot_mode="split23")
            return bcsr_spmm([tileplan_with_values(p, c) for p, c in zip(parts, cells)], hc)

        builds = []

        def counted(real):
            return lambda tp, bound=None: builds.append(tp.num_tiles) or real(tp, bound)

        with patched(cell_walk, "build_walk", counted):
            first = chain()
            built_first = len(builds)
            second = chain()
            torch.cuda.synchronize()
        check(len(builds) == built_first, f"the updateval chain built {len(builds) - built_first} lists again")
        check(torch.equal(first, second), "the updateval chain's two calls differ")
        chain_ms = dict(shared=cuda_time_ms(chain))
        with patched(cell_walk, "share_walk", lambda real: lambda src, dst: None):
            compare(chain(), first, "the chain over lists built at every call vs shared", gate=False)
            chain_ms["rebuilt"] = cuda_time_ms(chain)
            table_rebuilt = profile_table(chain)
        table_shared = profile_table(chain)
        log(f"  updateval chain: {built_first} lists built by the first call, 0 by the second; "
            f"{chain_ms['shared']:.3f} ms with the count plans' lists shared, {chain_ms['rebuilt']:.3f} ms with a "
            f"list built at every call (the earlier path)")
        log("  profile of the chain, lists rebuilt at every call (3 calls):\n" + table_rebuilt)
        log("  profile of the chain, lists shared (3 calls):\n" + table_shared)
    return dict(plans=stats, max_err=max_err, times=times, chain_ms=chain_ms, chain_builds_first=built_first)


def gather_plan(g, schedule: str, dev, with_transpose: bool = False, **kw):
    """Aggregator.schedule over ``g`` on ``dev``, its build seconds and
    stats() logged."""
    t0 = time.perf_counter()
    agg = Aggregator.schedule(g, schedule, with_transpose=with_transpose, device=dev, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"  {schedule} {kw} (transposed plan: {with_transpose}): built in {secs:.2f} s, {agg.plan.stats()}")
    return agg, dict(build_s=secs, stats=agg.plan.stats())


def fixed_degree_graph(n: int, degree: int, seed: int) -> CSRGraph:
    """Every node ``degree`` in-edges from sources drawn uniformly (numpy
    ``seed``): the bounded-degree graph the nop schedule is for."""
    rng = np.random.default_rng(seed)
    return CSRGraph(np.arange(n + 1, dtype=np.int64) * degree, rng.integers(0, n, n * degree))


def gather_edges(g, dev) -> tuple:
    """gcn_gates's edge lists for a gather plan: every edge is a residual
    edge (aggregated in float32 exactly, no tile rounding), no tile cell."""
    g_dst, g_src = edge_lists(g, dev)
    none = torch.zeros(0, dtype=torch.long, device=dev)
    return g_dst, g_src, None, g_dst, g_src, None, none, none, none.double()


def sddmm_gate(plan, a, b, g_dst, g_src, what: str):
    """The SDDMM of bench.py's gather path (f16_split2 source rows) in CSR
    edge order, through the plan's edge permutation, against the float64
    dot of every edge."""
    got = edge_values_from_slots_flat(plan, sddmm_slots(plan, a, b, gather_dtype="f16_split2"))
    ref = torch.empty(g_dst.shape[0], dtype=torch.float64, device=a.device)
    for s in range(0, ref.shape[0], CHECK_EDGES):
        d, sr = g_dst[s : s + CHECK_EDGES], g_src[s : s + CHECK_EDGES]
        ref[s : s + CHECK_EDGES] = (a.double().index_select(0, sr) * b.double().index_select(0, d)).sum(dim=1)
    bad = relative_error_count(got, ref)
    log(f"  {what}: {ref.numel()} edges vs f64 dots, gate_bad={bad}")
    check(bool(torch.isfinite(got).all()) and bad == 0, f"{what} fails the gate against the float64 dots")


def gather_phases(g, h0, gen) -> tuple:
    """Phases 40-43: the gather-only schedules and bench.py --strategy
    gather's paths over them (no kernel of the port runs there).  Returns
    the timings and the plans (phases 45-46 run the edge MLP over them)."""
    dev = h0.device
    n, m = g.num_nodes, g.num_edges
    edges = gather_edges(g, dev)
    g_dst, g_src = edges[:2]
    # ---- phase 40: plans
    log(f"phase 40: gather plans (Aggregator.schedule): NG B={GATHER_BLOCK}, locality + NG "
        f"{GATHER_PARTITIONS} partitions B={GATHER_BLOCK}, nop over a {NOP_DEGREE}-in-neighbour graph")
    ng, ng_info = gather_plan(g, "neighbor_grouping", dev, with_transpose=True, block_size=GATHER_BLOCK)
    lasng, lasng_info = gather_plan(
        g, "locality_neighbor_grouping", dev, num_partitions=GATHER_PARTITIONS, block_size=GATHER_BLOCK
    )
    fg = fixed_degree_graph(n, NOP_DEGREE, seed=16)
    nop, nop_info = gather_plan(fg, "nop", dev)
    check(nop.plan.block_size == NOP_DEGREE and lasng.plan.num_partitions == GATHER_PARTITIONS, "gather plan shapes")
    plans = dict(ng=ng_info, lasng=lasng_info, nop=nop_info)

    # ---- phase 41: the slice at full width
    log("phase 41: bench.py --strategy gather: GCN forward, SpMM f=128, spmm_nn f=32, SDDMM f=32, GAT forward")
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    opts = [LayerOpts()] * (len(BENCH_DIMS) - 1)
    xs = {}
    with torch.no_grad():
        for label, agg in (("NG", ng), ("locality+NG", lasng)):
            reset_counts()
            for _ in range(GATHER_CALLS):
                out = model(agg, h0)
            torch.cuda.synchronize()
            check(only_of(()), f"the gather GCN forward ({label}) launched a kernel")
            check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), f"gather forward ({label})")
            xs[label] = gcn_gates(agg, model.weights, opts, h0, out, edges, f"gather {label} ")
        h128 = torch.from_numpy(normal_features(n, BENCH_DIMS[1], seed=123) * 0.1).to(dev)
        ref128 = edge_sum(h128.double(), g_dst, g_src)
        for label, agg in (("NG", ng), ("locality+NG", lasng)):
            reset_counts()
            got = spmm(agg.plan, h128)
            torch.cuda.synchronize()
            check(only_of(()), "the gather SpMM launched a kernel")
            bad = relative_error_count(got, ref128)
            log(f"  SpMM pass ({label}) f=128 vs f64 oracle: gate_bad={bad} of {ref128.numel()}")
            check(bad == 0, f"the gather SpMM ({label}) fails the gate")
        f_dst, f_src = edge_lists(fg, dev)
        bad = relative_error_count(spmm(nop.plan, h128), edge_sum(h128.double(), f_dst, f_src))
        log(f"  SpMM pass (nop, {NOP_DEGREE}-in-neighbour graph) f=128 vs f64 oracle: gate_bad={bad}")
        check(bad == 0, "the nop SpMM fails the gate")
        del ref128, f_dst, f_src
        h32 = torch.from_numpy(normal_features(n, FUSED_F, seed=5) * 0.1).to(dev)
        w32 = torch.from_numpy(glorot_weights((FUSED_F, FUSED_F), seed=1)[0]).to(dev)
        agg32, trans = spmm_nn(ng.plan, h32, w32)
        ref32 = edge_sum(h32.double(), g_dst, g_src)
        bad = (relative_error_count(agg32, ref32), relative_error_count(trans, ref32 @ w32.double()))
        log(f"  spmm_nn f={FUSED_F} vs f64 oracle: agg gate_bad={bad[0]}, agg @ w gate_bad={bad[1]}")
        check(bad == (0, 0), "spmm_nn fails the gate")
        a = torch.from_numpy(normal_features(n, SDDMM_F, seed=3) * 0.1).to(dev)
        b = torch.from_numpy(normal_features(n, SDDMM_F, seed=4) * 0.1).to(dev)
        reset_counts()
        for _ in range(GATHER_CALLS):
            sddmm_slots(ng.plan, a, b, gather_dtype="f16_split2")
        torch.cuda.synchronize()
        check(only_of(()), "the gather SDDMM launched a kernel")
        sddmm_gate(ng.plan, a, b, g_dst, g_src, "SDDMM (NG, f16_split2)")
        sddmm_gate(lasng.plan, a, b, g_dst, g_src, "SDDMM (locality+NG: edges through edge_perm)")
        gat = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
        gat_out = {}
        for stabilize in (False, True):
            reset_counts()
            for _ in range(GATHER_CALLS):
                out = gat(ng.plan, h0, stabilize=stabilize)
            torch.cuda.synchronize()
            check(only_of(()), "the gather GAT forward launched a kernel")
            gat_gates(ng.plan, gat.layer_params(), h0, out, g, f"gather GAT stabilize={stabilize} ",
                      stabilize=stabilize)
            gat_out[stabilize] = out
        compare(gat_out[True], gat_out[False], "gather GAT stabilize=True vs un-stabilized", gate=True)
        p1 = gat.layer_params()[0]
        feat = h0 @ p1.w
        att = feat @ p1.w_att
        fused = gat_aggregate(ng.plan, feat, att)
        for adapter in (False, True):
            compare(gat_split_forward(ng.plan, feat, att, use_adapter=adapter), fused,
                    f"gat_split_forward ({'adapter' if adapter else 'base'}) vs gat_aggregate, layer 1", gate=True)
        del feat, att, fused

    # ---- phase 42: training
    log(f"phase 42: GCN training over the NG gather plan (B={GATHER_BLOCK}, transposed plan), {TRAIN_STEPS} steps")
    train = gcn_training(ng, g, h0, "gather ")
    check(all(v == 0 for v in train["counts"].values()), "gather GCN training launched a kernel")

    # ---- phase 43: timing
    log("phase 43: gather timing (CUDA events, median of 10 after 3 warm-up; profiler device time)")
    slots = ng.plan.num_tasks_padded * ng.plan.block_size
    t = dict(plans=plans, slots=slots, edges=m)
    with torch.no_grad():
        for label, agg in (("ng", ng), ("lasng", lasng)):
            xl = xs["NG" if label == "ng" else "locality+NG"]
            fw = two_clocks(lambda: model(agg, h0))
            fw["layer_ms"] = [cuda_time_ms(lambda: gcn_layer(agg, xl[i], w)) for i, w in enumerate(model.weights)]
            t[f"{label}_forward"] = fw
            log(f"  GCN forward ({label}): {fw['ms']:.3f} ms (device {fw['device_ms']}), layers "
                f"{' / '.join(f'{x:.3f}' for x in fw['layer_ms'])}")
        crow = torch.from_numpy(g.indptr.astype(np.int64)).to(dev)
        csr = torch.sparse_csr_tensor(crow, g_src, torch.ones(m, device=dev), (n, g.n_src))
        rows = []
        for f in BENCH_DIMS[1:]:
            x = torch.randn((g.n_src, f), generator=gen, device=dev)
            row = dict(f=f, ms=cuda_time_ms(lambda: spmm(ng.plan, x)),
                       lasng_ms=cuda_time_ms(lambda: spmm(lasng.plan, x)),
                       library_ms=cuda_time_ms(lambda: torch.sparse.mm(csr, x)),
                       **bound((slots + n) * f * 4.0, 2.0 * m * f))
            rows.append(row)
            log(f"  SpMM f={f}: NG {row['ms']:.3f} ms, locality+NG {row['lasng_ms']:.3f} | torch.sparse.mm "
                f"{row['library_ms']:.3f} | bound {row['bound_ms']:.4f} ({row['bound_by']}; {slots} slots)")
        t["spmm_rows"] = rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        spmm(ng.plan, h128)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        sp = two_clocks(lambda: spmm(ng.plan, h128))
        sp.update(edges_per_s=m / (sp["ms"] * 1e-3), peak_bytes=peak)
        t["spmm_pass"] = sp
        log(f"  SpMM pass f=128 (NG): {sp['ms']:.3f} ms (device {sp['device_ms']}) = {sp['edges_per_s']:.4g} "
            f"edges/s, peak {peak / 2**30:.3f} GiB above its inputs")
        sd = two_clocks(lambda: sddmm_slots(ng.plan, a, b, gather_dtype="f16_split2"))
        sd["edges_per_s"] = m / (sd["ms"] * 1e-3)
        t["sddmm_pass"] = sd
        log(f"  SDDMM pass f=32 (NG, f16_split2): {sd['ms']:.3f} ms (device {sd['device_ms']}) = "
            f"{sd['edges_per_s']:.4g} edges/s")
        for stabilize in (False, True):
            gm = two_clocks(lambda: gat(ng.plan, h0, stabilize=stabilize))
            t["gat_forward_stabilized" if stabilize else "gat_forward"] = gm
            log(f"  GAT forward (NG, stabilize={stabilize}): {gm['ms']:.3f} ms (device {gm['device_ms']})")
        # a yardstick the port never calls: P1 over the NG plan's task sums
        compare(cuda_residual.task_sums_cuda(ng.plan, h128), weighted_task_sums(ng.plan, h128, ng.plan.val),
                "P1 (yardstick) vs weighted_task_sums", gate=False)
        ts = dict(
            plain=two_clocks(lambda: weighted_task_sums(ng.plan, h128, ng.plan.val)),
            p1=two_clocks(lambda: cuda_residual.task_sums_cuda(ng.plan, h128)),
            **bound((slots + ng.plan.num_tasks_padded) * BENCH_DIMS[1] * 4.0, 2.0 * slots * BENCH_DIMS[1]),
        )
        t["task_sums"] = ts
        log(f"  task sums f=128 (NG): weighted_task_sums {ts['plain']['ms']:.3f} ms (device "
            f"{ts['plain']['device_ms']}) | P1 {ts['p1']['ms']:.3f} ms (device {ts['p1']['device_ms']}) | "
            f"bound {ts['bound_ms']:.4f}")
        del csr
    step_ms = cuda_time_ms(train["step"])
    fwd_ms = cuda_time_ms(lambda: train["fwd"](h0))
    t["train"] = dict(step_ms=step_ms, forward_ms=fwd_ms, backward_adam_ms=step_ms - fwd_ms, losses=train["losses"])
    log(f"  GCN training step (NG): {step_ms:.3f} ms = forward {fwd_ms:.3f} + backward and Adam {step_ms - fwd_ms:.3f}")
    return t, dict(ng=ng, lasng=lasng, nop=nop, nop_graph=fg)


def gather_reddit_phase(g, h0) -> tuple:
    """--scale reddit: bench.py --strategy gather's GCN forward over the NG
    plan (B = 32; spmm_plain's chunks of CHUNK_SLOTS slots), each layer
    held to phase 3's gates, its time and peak memory.  Returns them and
    the plan (phase 47 runs the edge MLP over it)."""
    dev = h0.device
    log(f"phase 41 (reddit): the gather GCN forward, NG B={GATHER_BLOCK}")
    ng, info = gather_plan(g, "neighbor_grouping", dev, block_size=GATHER_BLOCK)
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        out = model(ng, h0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check(only_of(()) and out.shape == (g.num_nodes, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()),
              "the reddit gather forward")
        gcn_gates(ng, model.weights, [LayerOpts()] * (len(BENCH_DIMS) - 1), h0, out, gather_edges(g, dev),
                  "reddit gather ")
        fw = two_clocks(lambda: model(ng, h0))
    log(f"  reddit gather GCN forward: {fw['ms']:.3f} ms (device {fw['device_ms']}), peak "
        f"{peak / 2**30:.3f} GiB above its inputs")
    return dict(plan=info, forward=fw, peak_bytes=peak), ng


# ------------------------------------------------ phases 44-47 (SAGE-LSTM, the edge MLP)
SAGE_K = 16  # bench.py's SAGE_K: the fixed-16-neighbour sample
SAGE_F = 32  # bench.py --model sage / edgemlp: f = 32
V100_SAGE_MS = 14.204  # bench.py's BASELINE_SAGE_EDGES_PER_S: the V100's reddit aggregate
# (label, strategy, gate_gather_dtype) of phase 44's LSTM runs; "bypass_f16"
# is bench.py --model sage's default (--layer-config fast)
LSTM_RUNS = (
    ("bypass", "redundancy_bypass", None),
    ("bypass_f16", "redundancy_bypass", torch.float16),
    ("sparse_fetch", "sparse_fetch", None),
    ("materialize", "materialize", None),
)
# float16 gate rows round at 2^-11, 32x coarser than the 16-bit 'split' tiles
# PURE_BAD_FRACTION bounds: near-zero hidden states (|ref| < 1.3e-3) then miss
# the gate's 1e-5 floor against the unrounded oracle.  On the quick inputs
# (CPU run) 37 of 2,097,152 elements, 1.8e-5, miss it, the same 37 as the JAX
# package's own float16 mode on the same inputs; against the oracle of the
# rounding every element passes.
F16_GATE_BAD_FRACTION = 1e-4
TORCH_GATE_ORDER = (0, 1, 3, 2)  # the port's [i, f, o, c~] slabs in torch.nn.LSTM's [i, f, g, o] order


def sage_inputs(g, dev) -> tuple:
    """bench.py --model sage's inputs: presample_fixed_neighbors(g, k=16,
    seed=2), x = normal_features(n, 32, seed=3) * 0.1; and the sample's
    host seconds."""
    t0 = time.perf_counter()
    nbr = torch.from_numpy(presample_fixed_neighbors(g, k=SAGE_K, seed=2)).to(dev)
    secs = time.perf_counter() - t0
    x = torch.from_numpy(normal_features(g.num_nodes, SAGE_F, seed=3) * 0.1).to(dev)
    log(f"  fixed-{SAGE_K} sample of n={g.num_nodes}: {secs:.2f} s on the host")
    return nbr, x, secs


def lstm_oracle(params, x, nbr, gx_all=None) -> torch.Tensor:
    """The LSTM's step loop (slabs [i, f, o, c~]) in float64 on the card;
    ``gx_all`` replaces x @ wx (a 16-bit mode's rounded gate rows)."""
    wx, wh, b = (p.double() for p in params)
    f = wh.shape[0]
    h = torch.zeros((nbr.shape[0], f), dtype=torch.float64, device=x.device)
    c = torch.zeros_like(h)
    gx_all = x.double() @ wx if gx_all is None else gx_all
    for t in range(nbr.shape[1]):
        z = gx_all.index_select(0, nbr[:, t].long()) + h @ wh + b
        i, fg, o = (torch.sigmoid(z[:, s * f : (s + 1) * f]) for s in range(3))
        c = fg * c + i * torch.tanh(z[:, 3 * f :])
        h = o * torch.tanh(c)
    return h


def f16_gates(params, x, nbr, out, ref, what: str) -> float:
    """A float16-gate run: 0 bad elements against the float64 oracle of its
    own rounding (the rounded gate rows), at most F16_GATE_BAD_FRACTION of
    them off the gate against the unrounded oracle.  Returns that share."""
    rounded = lstm_oracle(params, x, nbr, gx_all=(x @ params.wx).to(torch.float16).double())
    bad = relative_error_count(out, rounded)
    share = relative_error_count(out, ref) / out.numel()
    log(f"  {what}: vs the f64 oracle of its rounding gate_bad={bad}; vs the unrounded oracle "
        f"{share:.3e} of {out.numel()} off the gate (bound {F16_GATE_BAD_FRACTION}), max|d| "
        f"{(out - ref).abs().max().item():.3e}")
    check(bad == 0 and share <= F16_GATE_BAD_FRACTION, f"{what} fails its gates")
    return share


def edge_mlp_oracle(h, w, dst, src) -> torch.Tensor:
    """sum over edges of relu((h[dst] + h[src]) @ W) in float64 on the card,
    CHECK_EDGES edges at a time (index_add_ into the rows)."""
    h64, w64 = h.double(), w.double()
    out = torch.zeros((h.shape[0], w.shape[1]), dtype=torch.float64, device=h.device)
    for s in range(0, dst.shape[0], CHECK_EDGES):
        d, sr = dst[s : s + CHECK_EDGES], src[s : s + CHECK_EDGES]
        out.index_add_(0, d, torch.relu((h64.index_select(0, d) + h64.index_select(0, sr)) @ w64))
    return out


def edge_mlp_inputs(n: int, dev) -> tuple:
    """bench.py --model edgemlp's h = normal_features(n, 32, seed=3) * 0.1
    and W = normal_features(32, 32, seed=4) * 0.1."""
    return (torch.from_numpy(normal_features(n, SAGE_F, seed=3) * 0.1).to(dev),
            torch.from_numpy(normal_features(SAGE_F, SAGE_F, seed=4) * 0.1).to(dev))


def with_peak(fn) -> tuple:
    """(fn(), bytes the call allocated at its peak above what was live)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def timed(fn, edges: int) -> dict:
    """two_clocks of fn with edges/s and the call's peak bytes."""
    _, peak = with_peak(fn)
    t = two_clocks(fn)
    t.update(edges_per_s=edges / (t["ms"] * 1e-3), peak_bytes=peak)
    return t


def cudnn_lstm(params, f_in: int) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN) holding the port's weights, slabs permuted
    into its [i, f, g, o] layout, b_hh = 0: a yardstick the port never
    calls."""
    f = params.wh.shape[0]
    idx = torch.cat([torch.arange(s * f, (s + 1) * f) for s in TORCH_GATE_ORDER]).to(params.wx.device)
    lstm = torch.nn.LSTM(f_in, f, batch_first=True).to(params.wx.device)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(params.wx[:, idx].t())
        lstm.weight_hh_l0.copy_(params.wh[:, idx].t())
        lstm.bias_ih_l0.copy_(params.b[idx])
        lstm.bias_hh_l0.zero_()
    return lstm


def sage_edgemlp_phases(g, aggs: dict, dev) -> tuple:
    """Phases 44-46: bench.py --model sage's and --model edgemlp's paths at
    full width over the quick graph (no kernel of the port on either), held
    to float64 oracles on the card, then timed beside cuDNN's LSTM and the
    slot bound.  Returns the "sage" and "edgemlp" lines."""
    n, m = g.num_nodes, g.num_edges
    # ---- phase 44: SAGE-LSTM
    log(f"phase 44: SAGE-LSTM at full width (f={SAGE_F}, k={SAGE_K}): lstm_aggregate's three strategies, "
        f"float16 gates, sage_lstm_layer")
    nbr, x, sample_s = sage_inputs(g, dev)
    sp = init_sage_lstm_params(SAGE_F, SAGE_F, SAGE_F, torch.Generator(device=dev).manual_seed(0), device=dev)
    params = sp.lstm
    with torch.no_grad():
        ref = lstm_oracle(params, x, nbr)
        reset_counts()
        outs = {label: lstm_aggregate(params, x, nbr, strategy, gate_gather_dtype=gdt)
                for label, strategy, gdt in LSTM_RUNS}
        layer = sage_lstm_layer(sp, x, nbr)
        torch.cuda.synchronize()
        check(only_of(()), "the SAGE-LSTM path launched a kernel")
        for label, out in outs.items():
            check(out.shape == (n, SAGE_F) and bool(torch.isfinite(out).all()), f"LSTM {label} output")
            if label == "bypass_f16":
                share = f16_gates(params, x, nbr, out, ref, f"LSTM {label}")
                continue
            bad = relative_error_count(out, ref)
            log(f"  LSTM {label} vs f64 recurrence: gate_bad={bad} max|d|={(out - ref).abs().max().item():.3e}")
            check(bad == 0, f"LSTM {label} fails the gate")
        want = torch.relu(torch.cat([x.double() @ sp.w_self.double(), ref], dim=1) @ sp.w_out.double())
        bad = relative_error_count(layer, want)
        log(f"  sage_lstm_layer f_out={SAGE_F} vs f64: gate_bad={bad}")
        check(layer.shape == (n, SAGE_F) and bad == 0, "sage_lstm_layer fails the gate")
        lstm = cudnn_lstm(params, SAGE_F)
        xs = x.index_select(0, nbr.reshape(-1).long()).reshape(n, SAGE_K, SAGE_F)
        h_cudnn = lstm(xs)[1][0][0]
        bad = (relative_error_count(h_cudnn, outs["bypass"]), relative_error_count(h_cudnn, ref))
        log(f"  torch.nn.LSTM (cuDNN, yardstick) vs the port: gate_bad={bad[0]}; vs f64: gate_bad={bad[1]}")
        check(bad == (0, 0), "cuDNN's LSTM disagrees with the port")

        # ---- phase 45: the edge MLP
        log(f"phase 45: edge MLP at f={SAGE_F} (edge_mlp, edge_mlp_chunked) over NG, locality + NG and nop")
        h, w = edge_mlp_inputs(n, dev)
        g_dst, g_src = edge_lists(g, dev)
        em_ref = edge_mlp_oracle(h, w, g_dst, g_src)
        f_dst, f_src = edge_lists(aggs["nop_graph"], dev)
        refs = dict(ng=em_ref, lasng=em_ref, nop=edge_mlp_oracle(h, w, f_dst, f_src))
        del f_dst, f_src
        for key in ("ng", "lasng", "nop"):
            plan = aggs[key].plan
            for fn in (edge_mlp, edge_mlp_chunked):
                reset_counts()
                out = fn(plan, h, w)
                torch.cuda.synchronize()
                check(only_of(()), f"{fn.__name__} launched a kernel")
                bad = relative_error_count(out, refs[key])
                log(f"  {fn.__name__} ({key}) vs f64 edge list: gate_bad={bad} of {out.numel()}")
                check(bool(torch.isfinite(out).all()) and bad == 0, f"{fn.__name__} ({key}) fails the gate")
        del refs, em_ref

        # ---- phase 46: timing
        log("phase 46: SAGE-LSTM and edge MLP timing (CUDA events, median of 10 after 3 warm-up; profiler "
            "device time)")
        runs = {}
        for label, strategy, gdt in LSTM_RUNS:
            runs[label] = timed(lambda: lstm_aggregate(params, x, nbr, strategy, gate_gather_dtype=gdt), n * SAGE_K)
        runs["layer"] = timed(lambda: sage_lstm_layer(sp, x, nbr), n * SAGE_K)
        runs["cudnn"] = timed(lambda: lstm(xs), n * SAGE_K)
        for label, r in runs.items():
            log(f"  LSTM {label}: {r['ms']:.3f} ms (device {r['device_ms']}) = {r['edges_per_s']:.4g} edges/s, "
                f"peak {r['peak_bytes'] / 2**20:.1f} MiB")
        sage = dict(n=n, k=SAGE_K, f=SAGE_F, sample_s=sample_s, f16_off_gate_share=share, runs=runs,
                    cudnn_vs_bypass=runs["bypass"]["ms"] / runs["cudnn"]["ms"])
        ng = aggs["ng"].plan
        slots = ng.num_tasks_padded * ng.block_size
        em = dict(f=SAGE_F, edges=m, slots=slots,
                  **bound((slots + n) * SAGE_F * 4.0, 2.0 * n * SAGE_F * SAGE_F + 3.0 * slots * SAGE_F))
        em["ng"] = timed(lambda: edge_mlp(ng, h, w), m)
        em["ng_chunked"] = timed(lambda: edge_mlp_chunked(ng, h, w), m)
        em["lasng_chunked"] = timed(lambda: edge_mlp_chunked(aggs["lasng"].plan, h, w), m)
        em["nop_chunked"] = timed(lambda: edge_mlp_chunked(aggs["nop"].plan, h, w), n * NOP_DEGREE)
        for key in ("ng", "ng_chunked", "lasng_chunked", "nop_chunked"):
            r = em[key]
            log(f"  edge MLP {key}: {r['ms']:.3f} ms (device {r['device_ms']}) = {r['edges_per_s']:.4g} edges/s, "
                f"peak {r['peak_bytes'] / 2**20:.1f} MiB | slot bound (NG) {em['bound_ms']:.4f} ({em['bound_by']})")
    return sage, em


def sage_edgemlp_reddit_phase(g, ng, dev) -> tuple:
    """Phase 47 (--scale reddit): the SAGE aggregate (float16 gates, bench.py
    --model sage's default) over the uncut graph beside the V100 anchor, and
    the edge MLP over the reddit NG plan, each held to its float64 oracle."""
    n, m = g.num_nodes, g.num_edges
    log(f"phase 47 (reddit): SAGE-LSTM aggregate (k={SAGE_K}, float16 gates), edge MLP over the NG plan")
    nbr, x, sample_s = sage_inputs(g, dev)
    params = init_lstm_params(SAGE_F, SAGE_F, torch.Generator(device=dev).manual_seed(0), device=dev)
    run = lambda: lstm_aggregate(params, x, nbr, gate_gather_dtype=torch.float16)  # noqa: E731
    with torch.no_grad():
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        check(only_of(()) and out.shape == (n, SAGE_F) and bool(torch.isfinite(out).all()), "the reddit SAGE path")
        share = f16_gates(params, x, nbr, out, lstm_oracle(params, x, nbr), "reddit LSTM bypass_f16")
        sage = timed(run, n * SAGE_K)
        sage.update(n=n, k=SAGE_K, sample_s=sample_s, f16_off_gate_share=share, v100_ms=V100_SAGE_MS,
                    vs_v100=V100_SAGE_MS / sage["ms"])
        log(f"  reddit SAGE aggregate: {sage['ms']:.3f} ms (device {sage['device_ms']}) = {sage['edges_per_s']:.4g} "
            f"edges/s, peak {sage['peak_bytes'] / 2**20:.1f} MiB; V100 anchor {V100_SAGE_MS} ms")
        del nbr, x, out
        h, w = edge_mlp_inputs(n, dev)
        reset_counts()
        out = edge_mlp_chunked(ng.plan, h, w)
        torch.cuda.synchronize()
        check(only_of(()) and bool(torch.isfinite(out).all()), "the reddit edge MLP")
        bad = relative_error_count(out, edge_mlp_oracle(h, w, *edge_lists(g, dev)))
        log(f"  reddit edge_mlp_chunked (NG) vs f64 edge list: gate_bad={bad} of {out.numel()}")
        check(bad == 0, "the reddit edge MLP fails the gate")
        slots = ng.plan.num_tasks_padded * ng.plan.block_size
        em = timed(lambda: edge_mlp_chunked(ng.plan, h, w), m)
        em.update(slots=slots, **bound((slots + n) * SAGE_F * 4.0, 2.0 * n * SAGE_F * SAGE_F + 3.0 * slots * SAGE_F))
        log(f"  reddit edge MLP: {em['ms']:.3f} ms (device {em['device_ms']}) = {em['edges_per_s']:.4g} edges/s, "
            f"peak {em['peak_bytes'] / 2**30:.3f} GiB; slot bound {em['bound_ms']:.4f}")
    return sage, em


# ------------------------------------------------ phases 48-50 (the reorders, the CLI, decompose)
# bench.py --reorder: hublpa is --graph community's default, degree rmat's
RMAT_REORDERS = ("degree", "lpa", "cluster", "cluster_exact")
CLI_SYN = "rmat:65536:1048576"  # the JAX README's quick-start graph
CLI_ITERS = 2  # tune --iters
CLI_EPOCHS = 5  # train --epochs
# decompose's dense phase against the kernel's per-launch time of phases 4
# and 7 on the same plan (a larger gap is a finding, not a gate to widen)
DECOMPOSE_TOL = 0.3


def reorder_perm(g, name: str) -> tuple:
    """(permutation, host seconds) of bench.py's ``--reorder name``; the
    permutation must be a bijection."""
    t0 = time.perf_counter()
    if name == "hublpa":
        perm = label_propagation_reorder(g, hubs=max(256, g.num_nodes // 128))
    elif name == "lpa":
        perm = label_propagation_reorder(g)
    elif name == "cluster":
        perm = cluster_reorder(g)
    elif name == "cluster_exact":
        perm = cluster_reorder_exact(g)
    else:
        perm = degree_sort(g)
    secs = time.perf_counter() - t0
    check(np.array_equal(np.sort(perm), np.arange(g.num_nodes)), f"the {name} reorder is not a bijection")
    return perm, secs


def plan_row(agg, g, build_s: float) -> dict:
    """A hybrid plan's tiles, the share of edges they cover and the
    residual's slots."""
    tp = agg.tile
    return dict(
        tiles=tp.num_tiles, dense_edge_share=tp.num_dense_edges / g.num_edges,
        residual_slots=agg.plan.num_tasks_padded * agg.plan.block_size, plan_build_s=build_s,
    )


def reorder_gcn(g, h0, forwards: int, what: str) -> dict:
    """Phase 3's path over the reordered ``g``: the int8 [512, 256] t48
    plan, ``forwards`` GCN forwards (fast_layer_opts; B1 3 launches a
    forward, no other kernel), gcn_gates with ``pure="beyond_modes"``: the
    modes' oracle 0 bad, and misses of the unrounded one counted where the
    modes' own float64 result meets it ('split' tiles miss it at
    cancellation points, more of them on the community graph than on phase
    3's; PERF.md); the whole chain's share is printed, not gated.  Then
    the forward's ms by CUDA events and device time."""
    dev = h0.device
    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE
    )
    torch.cuda.synchronize()
    row = plan_row(agg, g, time.perf_counter() - t0)
    _, res_host = densify(g, dtype=np.int8, **SCHEDULE)
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    opts = fast_layer_opts(BENCH_DIMS)
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        row["launches"] = cuda_bcsr.launches
        check(only_with_r1("B1", forwards * residual_layers(agg, opts)) and row["launches"] == 3 * forwards,
              f"{what}: B1 did not launch 3 times a forward, with R1 once a float32-row layer, alone")
        check(out.shape == (g.num_nodes, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), f"{what}: forward output")
        edges = gcn_edges(g, res_host, agg.tile)
        gcn_gates(agg, model.weights, opts, h0, out, edges, f"{what}: ", pure="beyond_modes")
        del edges
        clocks = two_clocks(lambda: model(agg, h0, opts))
    row.update(forward_ms=clocks["ms"], forward_device_ms=clocks["device_ms"])
    log(
        f"  {what}: tiles={row['tiles']} dense edge share={row['dense_edge_share']:.4f} "
        f"residual slots={row['residual_slots']} | B1 launches {row['launches']} in {forwards} forwards | "
        f"forward {row['forward_ms']:.3f} ms (device {row['forward_device_ms']})"
    )
    return row


def reorder_phase(h0, forwards: int) -> dict:
    """Phase 48: bench.py --graph community (its default reorder hublpa) and
    --reorder lpa|cluster|cluster_exact|degree over the quick RMAT graph, each
    through phase 3's GCN forward and its gates; the community graph also
    through the stabilized GAT forward with phase 6's gates."""
    dev = h0.device
    n, m = SCALES["quick"]
    log("phase 48: the reorders on the card's path (bench.py --graph community --reorder hublpa, "
        "--reorder lpa|cluster|cluster_exact|degree)")
    log(f"  bench.py --quick --graph community geometry: GCN {SCHEDULE}, GAT {GAT_SCHEDULE}, residual "
        f"{RESIDUAL_BLOCK}, int8 tiles")
    t0 = time.perf_counter()
    gc = community_graph(n, m, seed=123, with_val=False)
    gen_s = time.perf_counter() - t0
    perm, secs = reorder_perm(gc, "hublpa")
    gc = gc.reorder(perm)
    log(f"  community graph n={n} m={m}: generated in {gen_s:.2f} s; hublpa (hubs {max(256, n // 128)}) in "
        f"{secs:.2f} s (host)")
    community = reorder_gcn(gc, h0, forwards, "community hublpa GCN")
    community.update(reorder="hublpa", reorder_s=secs, graph_s=gen_s, geometry=SCHEDULE)

    t0 = time.perf_counter()
    agg = Aggregator.schedule_hybrid(
        gc, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, device=dev,
        **GAT_SCHEDULE,
    )
    torch.cuda.synchronize()
    gat = plan_row(agg, gc, time.perf_counter() - t0)
    gat_model = gat_params_from_jax(glorot_gat_weights(BENCH_DIMS, seed=0), device=dev)
    fwd = lambda: gat_model(agg, h0, fast=True, dot_mode="split2", stabilize=True)  # noqa: E731
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = fwd()
        torch.cuda.synchronize()
        gat.update(launches=cuda_gat.launches, rowmax_launches=cuda_rowmax.launches)
        check(only_of(("B2", "B5")) and gat["launches"] == 3 * forwards and gat["rowmax_launches"] == 3 * forwards,
              "community GAT forward (stabilize=True): B2 and B5 not 3 launches a forward each")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "community GAT forward output")
        gat_gates(agg, gat_model.layer_params(), h0, out, gc, "community hublpa GAT: ", stabilize=True)
        clocks = two_clocks(fwd)
    gat.update(forward_ms=clocks["ms"], forward_device_ms=clocks["device_ms"], geometry=GAT_SCHEDULE)
    log(
        f"  community hublpa GAT (stabilize=True): tiles={gat['tiles']} dense edge share="
        f"{gat['dense_edge_share']:.4f} | B2 {gat['launches']}, B5 {gat['rowmax_launches']} launches in {forwards} "
        f"forwards | forward {gat['forward_ms']:.3f} ms (device {gat['forward_device_ms']})"
    )
    community["gat"] = gat
    del agg, gat_model, gc, out
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    g_raw = rmat_graph(n, m, seed=123, with_val=False)
    log(f"  phase 1's RMAT graph regenerated in {time.perf_counter() - t0:.2f} s")
    rmat = {}
    for name in RMAT_REORDERS:
        perm, secs = reorder_perm(g_raw, name)
        log(f"  rmat {name}: reordered in {secs:.2f} s (host)")
        rmat[name] = reorder_gcn(g_raw.reorder(perm), h0, forwards, f"rmat {name} GCN")
        rmat[name]["reorder_s"] = secs
        torch.cuda.empty_cache()
    return dict(community=community, rmat=rmat)


def cli_json(argv) -> dict:
    """utils.cli.main(argv) in this process (so the launch counts can be
    read); its last stdout line must parse as JSON."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    secs = time.perf_counter() - t0
    last = buf.getvalue().strip().splitlines()[-1]
    log(f"  {' '.join(argv)} ({secs:.2f} s): {last[:400]}{' ...' if len(last) > 400 else ''}")
    out = json.loads(last)
    check(isinstance(out, dict), f"cli {argv[0]} printed no JSON object")
    return out


def cli_phase() -> dict:
    """Phase 49: the CLI on the card, in this process, over the JAX README's
    quick-start graph: info, schedule, bench (gcn, gat, sage_lstm over the
    gather plan: no kernel), tune (B1 over every hybrid candidate's tiles)
    and train (a gather plan: no kernel; the loss finite and falling)."""
    log(f"phase 49: the CLI on the card (utils.cli.main, --syn {CLI_SYN})")
    syn = ["--syn", CLI_SYN]
    out = dict(info=cli_json(["info", *syn]), schedule=cli_json(["schedule", *syn]))
    check(out["info"]["num_nodes"] == int(CLI_SYN.split(":")[1]) and out["schedule"]["num_edges"] == out["info"]["num_edges"],
          "cli info / schedule")
    out["bench"] = {}
    for model in ("gcn", "gat", "sage_lstm"):
        reset_counts()
        r = cli_json(["bench", *syn, "--model", model])
        torch.cuda.synchronize()
        check(only_of(()) and r["model"] == model and r["seconds"] > 0 and math.isfinite(r["edges_per_s"]),
              f"cli bench --model {model}")
        out["bench"][model] = r
    reset_counts()
    r = cli_json(["tune", *syn, "--iters", str(CLI_ITERS)])
    torch.cuda.synchronize()
    c = counts()
    # the synthetic graph carries edge values, so int8 tiles are skipped
    want = [{"block_size": b, "strategy": "gather"} for b in (8, 16, 32, 64)] + [
        {"tile_rows": rows, "threshold": t, "tile_dtype": "bf16", "strategy": "hybrid"}
        for rows in (256, 512) for t in (16, 24, 48)
    ]
    check([{k: v for k, v in row.items() if k != "seconds"} for row in r["table"]] == want,
          "cli tune: its table does not list every candidate")
    check(all(row["seconds"] > 0 for row in r["table"]), "cli tune: a candidate without a time")
    log(f"  tune: B1 {c['B1']} launches ({cuda_bcsr.float_launches} over bfloat16 tiles); best {r['best']}")
    check(c["B1"] > 0 and cuda_bcsr.float_launches == c["B1"] and only_of(("B1", "R1")),
          "cli tune did not launch B1 (and the hybrid residual's R1) alone")
    out["tune"] = dict(r, launches=c["B1"])
    reset_counts()
    r = cli_json(["train", *syn, "--epochs", str(CLI_EPOCHS)])
    torch.cuda.synchronize()
    losses = r["losses"]
    check(only_of(()) and len(losses) == CLI_EPOCHS and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0], "cli train: the loss is not finite and falling")
    out["train"] = r
    return out


def decompose_phase(g, gen, b1_rows, b2_rows, dev) -> dict:
    """Phase 50: profiling.decompose over phase 3's int8 plan (gcn) and phase
    6's GAT plan (gat), rebuilt alike, at f = 128, 64, 32: every phase present
    and finite, ``dense`` launching B1 (B2), within DECOMPOSE_TOL of the
    kernel's per-launch time that phase 4 (7) took on the same plan at the
    same f, and ``analytic`` equal to plan_cost / tile_cost."""
    n = g.num_nodes
    log("phase 50: profiling.decompose on the card (GCN over phase 3's plan, GAT over phase 6's)")
    out = {}
    for model, schedule, rows, key in (("gcn", SCHEDULE, b1_rows, "B1"), ("gat", GAT_SCHEDULE, b2_rows, "B2")):
        agg = Aggregator.schedule_hybrid(
            g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, device=dev,
            **schedule,
        )
        out[model] = []
        for row in rows:
            f = row["f"]
            h = torch.rand((n, f), generator=gen, device=dev)
            att = torch.randn((n, 2), generator=gen, device=dev) * 0.1
            reset_counts()
            d = decompose(agg, h, model=model, att=att)
            torch.cuda.synchronize()
            launches = counts()[key]
            phases = ("dense", "residual", "residual_floor", "transform") + (("total",) if model == "gcn" else ())
            check(all(p in d and math.isfinite(d[p]["ms"]) and d[p]["ms"] > 0 for p in phases),
                  f"decompose {model} f={f}: a phase is missing or not finite")
            # the GCN's "total" phase is agg.run: the hybrid residual's R1 beside B1
            others = ("R1",) if model == "gcn" else ()
            check(launches > 0 and only_of((key, *others)), f"decompose {model} f={f}: dense did not launch {key} alone")
            check(d["analytic"] == {"plan": plan_cost(agg.plan, f), "tile": [tile_cost(t, f) for t in agg.tile_parts()]},
                  f"decompose {model} f={f}: analytic differs from plan_cost / tile_cost")
            ratio = d["dense"]["ms"] / row["ms"]
            log(
                f"  {model} f={f}: " + ", ".join(f"{p} {d[p]['ms']:.4f} ms" for p in phases)
                + f" | {key} launches {launches}; dense / phase {4 if model == 'gcn' else 7}'s {key} "
                f"{row['ms']:.4f} ms = {ratio:.3f}"
            )
            check(abs(ratio - 1.0) <= DECOMPOSE_TOL,
                  f"decompose {model} f={f}: dense {d['dense']['ms']:.4f} ms is not within "
                  f"{DECOMPOSE_TOL:.0%} of the kernel's {row['ms']:.4f} ms")
            out[model].append(dict(f=f, launches=launches, kernel_ms=row["ms"], dense_ratio=ratio,
                                   **{p: d[p] for p in phases}))
        del agg
        torch.cuda.empty_cache()
    return out

# ------------------------------------------------ phases 51-54 (multi-device on torch.distributed)
PAR_D = 4  # rank bodies of phases 51, 52 and 54
ARXIV_D = 8  # phase 53: the dry run's arxiv-scale forward
# phase 51: build_allgather_hybrid at bench.py's GCN geometry, 1-bit and int8 groups
AG_SCHEDULE = dict(SCHEDULE, residual_block=RESIDUAL_BLOCK, tile_dtype=np.int8, bit_tiles=True, pack=8)
RING_GRAPH = (1 << 15, 1 << 20)  # phase 54's RMAT (seed 123, degree sorted)
PAR_TOL = 1e-5  # max|d| <= PAR_TOL * max|ref| against the single-card port: float32 summation order


def close_to(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    scale = want.abs().max().item() if want.numel() else 0.0
    log(f"  {what}: max|d|={err:.3e} max|ref|={scale:.3e}")
    check(err <= PAR_TOL * scale, f"{what}: off the single-card port by more than {PAR_TOL} max|ref|")
    return err


def layer_gates(g, ws, h0, out, aggregate, what: str) -> list:
    """Each layer of a GCN forward (transform, aggregate, ReLU but after the
    last) from its own float32 input against the float64 edge oracle of the
    layer's own float32 transform: 0 elements off the gate; the chain of
    layers must be ``out``.  Returns the layer inputs."""
    g_dst, g_src = edge_lists(g, h0.device)
    xs = [h0]
    for i, w in enumerate(ws):
        z = xs[i] @ w
        y, ref = aggregate(z), edge_sum(z.double(), g_dst, g_src)
        if i < len(ws) - 1:
            y, ref = torch.relu(y), ref.clamp_min_(0.0)
        bad = relative_error_count(y, ref)
        log(f"  {what}layer {i + 1} (f={z.shape[1]}) vs f64 edge oracle: gate_bad={bad} of {ref.numel()}")
        check(bad == 0, f"{what}layer {i + 1} fails the gate against the float64 oracle")
        xs.append(y)
    # the residual's index_add_ adds in atomic order on the card, so the
    # layers recomputed one by one match the forward to float32 sum order
    err = (xs[-1] - out).abs().max().item()
    check(err <= PAR_TOL * out.abs().max().item(), f"{what}the layers do not chain to the forward's output ({err:.3e})")
    return xs


def b1_bound(tp, f: int, nnz: int) -> tuple:
    """(bound ms, bound_by) of one B1 launch: its tiles, column indices and
    runs read once, the h rows of the column tiles it touches read once and
    its output rows written once, at the card's memory rate; 2 nnz f
    float32 operations at its peak rate."""
    cols = int(torch.unique(tp.tile_col).numel()) if tp.num_tiles else 0
    move = tp.a.numel() + 4 * (tp.num_tiles + tp.num_row_tiles + 1) + 4 * f * (min(cols * tp.tile_cols, tp.n_src)
                                                                               + tp.num_nodes)
    bytes_ms, ops_ms = move / HBM_BYTES_PER_S * 1e3, 2.0 * nnz * f / FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def group_rows(views, xs_of, fs, gen, what: str, transposed: bool = False) -> tuple:
    """B1 over every group of every rank body (or the groups' transposes),
    against bcsr_spmm_plain (nonnegative and signed h, KERNEL_TOL) and timed
    (CUDA events, median of 10 after 3): per (f, rank) the ms a body's
    launches take together, their plain version's, their bound and
    torch.sparse.mm over the same cells (a yardstick the port never
    calls).  ``xs_of(f, r, local)`` gives a body's operand."""
    rows, err = [], 0.0
    for f in fs:
        for r, v in enumerate(views):
            row = dict(f=f, rank=r, launches=0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bound_by="bytes")
            for k, (tp, tp_t, local) in enumerate(v.groups):
                p = tp_t if transposed else tp
                label = f"{what} rank {r} group {k} ({'1-bit' if p.bits else p.format}, {'local' if local else 'halo'})"
                err = max(err, kernel_vs_plain(p, f, "native", gen, label))
                x = xs_of(f, r, local) if not transposed else torch.randn((p.n_src, f), generator=gen, device=p.a.device)
                csr = tile_csr(p)
                bound, by = b1_bound(p, f, csr.values().numel())
                row["launches"] += 1
                row["ms"] += cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(p, x))
                row["plain_ms"] += cuda_time_ms(lambda: bcsr_spmm_plain(p, x))
                row["library_ms"] += cuda_time_ms(lambda: torch.sparse.mm(csr, x))
                row["bound_ms"] += bound
                row["bound_by"] = by if row["bound_by"] == "bytes" else row["bound_by"]
            rows.append(row)
            log(f"  {what} f={f} rank {r}: B1 {row['ms']:.4f} ms over {row['launches']} launches | bound "
                f"{row['bound_ms']:.4f} | plain {row['plain_ms']:.3f} | torch.sparse.mm {row['library_ms']:.4f}")
    return rows, err


def allgather_phase(g, h0, gen) -> dict:
    """Phase 51: the all-gather hybrid GCN at full width over phase 1's
    graph (build_allgather_hybrid at D = 4, 1-bit and int8 groups, pack 8,
    with the groups' transposes): the 4 rank bodies on the card, each given
    its rows and the whole buffer (what the all-gather gives it)."""
    dev = h0.device
    log(f"phase 51: the all-gather hybrid GCN, D = {PAR_D} rank bodies on the card ({AG_SCHEDULE})")
    t0 = time.perf_counter()
    plan, gp = build_allgather_hybrid(g, PAR_D, with_transpose=True, **AG_SCHEDULE)
    build_s = time.perf_counter() - t0
    views = shard_all(plan, dev)
    ngroups = len(plan.groups)
    nbits = sum(grp.bits for grp in plan.groups)
    # a rank's view leaves out its all-zero tiles, and a group without others
    bodies_groups = sum(len(v.groups) for v in views)
    bodies_bits = sum(tp.bits for v in views for tp, _, _ in v.groups)
    log(f"  plan: n_pad={plan.n_pad} groups={ngroups} ({nbits} 1-bit) "
        + ", ".join(f"{'1-bit' if grp.bits else 'int8'} {'local' if grp.local else 'halo'} T={grp.a.shape[1]}"
                    for grp in plan.groups)
        + f" residual tasks {plan.rcnt.shape[1]} halo + {plan.lcnt.shape[1]} local a rank; built in {build_s:.1f} s")
    check(gp.num_nodes == g.num_nodes, "the quick graph needs no padding at D = 4")
    ws = [torch.from_numpy(w).to(dev) for w in glorot_weights(BENCH_DIMS, seed=0)]
    fwd = lambda: allgather_hybrid_gcn_forward_bodies(views, ws, h0)  # noqa: E731
    with torch.no_grad():
        reset_counts()
        out = fwd()
        torch.cuda.synchronize()
        launches, bits = cuda_bcsr.launches, cuda_bcsr.bits_launches
        want = 3 * bodies_groups
        log(f"  B1 launches in one forward: {launches} ({bits} 1-bit); {bodies_groups} non-empty (rank, group) "
            f"views of {PAR_D} x {ngroups} x 3 layers; nonzero tiles a view: "
            + ", ".join(str(tp.num_tiles) for v in views for tp, _, _ in v.groups))
        check(only("B1") and launches == want and bits == 3 * bodies_bits,
              "the all-gather forward did not launch B1 once a non-empty group, layer and rank")
        check(out.shape == (g.num_nodes, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "all-gather forward output")
        xs = layer_gates(g, ws, h0, out, lambda z: allgather_hybrid_spmm_bodies(views, z), "all-gather ")
        single = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, bit_tiles=True, with_transpose=False,
                                            residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE)
        max_err = close_to(out, gcn_forward(single, ws, h0), "all-gather forward vs the single-card schedule_hybrid")
        del single
        forward_ms = cuda_time_ms(fwd)
        ns = plan.shard_size
        zs = {w.shape[1]: (xs[i] @ w).contiguous() for i, w in enumerate(ws)}
        bodies = []
        for i, w in enumerate(ws):
            z = zs[w.shape[1]]
            for r, v in enumerate(views):
                bodies.append(dict(layer=i + 1, f=z.shape[1], rank=r, ms=cuda_time_ms(
                    lambda: _local_allgather_hybrid(v, z[r * ns : (r + 1) * ns], z))))
        log("  rank bodies (ms, layer x rank): " + ", ".join(f"{b['ms']:.3f}" for b in bodies)
            + f" | whole forward {forward_ms:.3f} ms")
        fs = sorted(zs, reverse=True)
        rows, err = group_rows(views, lambda f, r, local: zs[f][r * ns : (r + 1) * ns] if local else zs[f], fs, gen,
                               "all-gather")
        rows_t, err_t = group_rows(views, None, fs, gen, "all-gather transposed", transposed=True)
    return dict(plan_build_s=build_s, groups=ngroups, bit_groups=nbits, views=bodies_groups, launches=launches,
                bits_launches=bits,
                launches_per_forward=want, max_err=max_err, kernel_max_err=max(err, err_t), forward_ms=forward_ms,
                bodies=bodies, rows=rows, rows_t=rows_t)


def nccl_world_phase(dev) -> dict:
    """Phase 52: the dry run's training step (multichip.train_step: the
    all-gather hybrid, ring hybrid and gather ring, B1 over the all-gather
    groups and their transposes) in an NCCL world of one on the card, held
    to the same step in a gloo group on the CPU (plain versions); and the
    D = 4 rank bodies' forwards against the world of one's over the same
    graph."""
    log(f"phase 52: the dry run's training step in an NCCL world of one (toy graph of D = {PAR_D})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh(num_graph=1, device=dev)
        cpu_mesh = make_mesh(num_graph=1, device="cpu", backend="gloo")
        prob = multichip.toy_problem(1, graph_devices=PAR_D)
        w0 = [p.detach().numpy() for p in multichip.toy_params("cpu")]
        params = multichip.toy_params(dev, w0)
        opt = torch.optim.Adam(params, lr=multichip.LR)
        # the plan parts go to the card once, outside the timed step
        shards = multichip.toy_shards(mesh, prob)
        ngroups = len(shards[0].groups)
        reset_counts()
        loss, grads = multichip.train_step(mesh, prob, params, opt, shards)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        layers = len(multichip.TOY_DIMS) - 1
        log(f"  step: loss {loss:.6f}; B1 launches {launches} ({ngroups} groups x {layers} layers, forward and "
            f"backward over the transposes)")
        check(math.isfinite(loss), "the dry run's loss is not finite")
        check(only("B1") and launches == 2 * layers * ngroups, "the step did not launch B1 once a group and layer, "
              "forward and backward")
        cparams = multichip.toy_params("cpu", w0)
        closs, cgrads = multichip.train_step(cpu_mesh, prob, cparams, torch.optim.Adam(cparams, lr=multichip.LR),
                                             multichip.toy_shards(cpu_mesh, prob))
        rels = [rel_l2(a.cpu(), b.double()) for a, b in zip(grads, cgrads)]
        log(f"  the same step on the CPU (gloo, plain versions): loss {closs:.6f}; gradients' relative L2 {rels}")
        check(abs(loss - closs) <= 1e-5 * abs(closs) and max(rels) <= GRAD_REL_L2,
              "the card's step differs from the CPU's")
        p0 = multichip.toy_params(dev, w0)
        n = prob.labels.shape[0]
        with torch.no_grad():
            one = multichip.toy_forwards(mesh, prob, p0, shards)
            four = multichip.toy_forwards_bodies(multichip.toy_problem(PAR_D), p0, dev)
            for a, b, name in zip(four, one, ("all-gather", "ring hybrid", "ring")):
                close_to(a[:n], b[:n], f"{name} logits: D = {PAR_D} rank bodies vs the world of one")
        step_ms = cuda_time_ms(lambda: multichip.train_step(mesh, prob, params, opt, shards))
        log(f"  step {step_ms:.3f} ms (CUDA events, the world of one; plan parts on the card before it, the toy "
            f"features and labels copied in it)")
        return dict(loss=loss, cpu_loss=closs, grad_rel_l2=rels, launches=launches, groups=ngroups, step_ms=step_ms,
                    params=[p.detach() for p in params])
    finally:
        dist.destroy_process_group()


def arxiv_phase(params, gen) -> dict:
    """Phase 53: the dry run's all-gather forward at arxiv scale (RMAT
    169,343 v / 1,166,243 e, seed 11; [256, 128] t16, residual 4, pack 8,
    f = 32) with the step's weights, as D = 8 rank bodies on the card."""
    dev = params[0].device
    log(f"phase 53: the all-gather forward at arxiv scale, D = {ARXIV_D} rank bodies")
    t0 = time.perf_counter()
    plan, gp = multichip.arxiv_plan(ARXIV_D)
    build_s = time.perf_counter() - t0
    views = shard_all(plan, dev)
    ha = torch.from_numpy(multichip.arxiv_features(plan.n_pad)).to(dev)
    ngroups = sum(len(v.groups) for v in views)
    fwd = lambda: allgather_hybrid_gcn_forward_bodies(views, params, ha)  # noqa: E731
    with torch.no_grad():
        reset_counts()
        out = fwd()
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        log(f"  n_pad={plan.n_pad} non-empty (rank, group) views={ngroups} of {ARXIV_D} x {len(plan.groups)}, built "
            f"in {build_s:.1f} s; B1 launches {launches}")
        check(only("B1") and launches == len(params) * ngroups, "arxiv forward: B1 not once a group, body and layer")
        check(bool(torch.isfinite(out).all()), "arxiv forward: non-finite output")
        xs = layer_gates(gp, params, ha, out, lambda z: allgather_hybrid_spmm_bodies(views, z), "arxiv ")
        forward_ms = cuda_time_ms(fwd)
        ns = plan.shard_size
        zs = {w.shape[1]: (xs[i] @ w).contiguous() for i, w in enumerate(params)}
        rows, err = group_rows(views, lambda f, r, local: zs[f][r * ns : (r + 1) * ns] if local else zs[f],
                               sorted(zs, reverse=True), gen, "arxiv")
    log(f"  arxiv forward {forward_ms:.3f} ms")
    return dict(plan_build_s=build_s, n_pad=plan.n_pad, groups=ngroups, launches=launches, forward_ms=forward_ms,
                kernel_max_err=err, rows=rows)


def ring_feature_phase(gen, dev) -> dict:
    """Phase 54: the gather ring, the ring-hybrid GCN and GAT (plain torch,
    as the JAX package leaves them to XLA: no kernel launched) and the
    feature-parallel forward (B1 through Aggregator.run a rank and layer),
    each as D = 4 rank bodies against the single-card port."""
    n, m = RING_GRAPH
    log(f"phase 54: ring, ring hybrid (GCN, GAT) and feature-parallel forwards, D = {PAR_D} rank bodies "
        f"(RMAT n={n} m={m}, seed 123, degree sorted)")
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    ws = [torch.from_numpy(w).to(dev) for w in glorot_weights(BENCH_DIMS, seed=0)]
    h = torch.from_numpy(normal_features(n, BENCH_DIMS[0], seed=5) * 0.1).to(dev)
    out = {}
    with torch.no_grad():
        # every rank's plan parts go to the card once, outside the timed forwards
        ring, gp, _ = build_ring_plan(g, PAR_D, block_size=GATHER_BLOCK)
        rings = shard_all(ring, dev)
        reset_counts()
        got = ring_gcn_forward_bodies(rings, ws, h)
        torch.cuda.synchronize()
        check(only_of(()), "the ring launched a kernel")
        single = Aggregator.schedule(gp, "neighbor_grouping", with_transpose=False, device=dev, block_size=GATHER_BLOCK)
        out["ring"] = dict(max_err=close_to(got, gcn_forward(single, ws, h), "ring GCN vs the single-card gather"),
                           ms=cuda_time_ms(lambda: ring_gcn_forward_bodies(rings, ws, h)),
                           tasks_per_step=ring.tasks_per_step)
        del ring, rings, single
        rtp, hring, gph = build_ring_hybrid(g, PAR_D, tile_rows=256, tile_cols=128)
        check(gph.num_nodes == n, "phase 54's graph needs no padding")
        tiles, hrings = shard_all(rtp, dev), shard_all(hring, dev)
        reset_counts()
        got = ring_hybrid_gcn_forward_bodies(tiles, hrings, ws, h)
        torch.cuda.synchronize()
        check(only_of(()), "the ring hybrid launched a kernel")
        single = Aggregator.schedule_hybrid(g, tile_rows=256, tile_cols=128, residual_block=8, with_transpose=False,
                                            pack=1, device=dev)
        out["ring_hybrid"] = dict(
            max_err=close_to(got, gcn_forward(single, ws, h), "ring-hybrid GCN vs the single-card schedule_hybrid"),
            ms=cuda_time_ms(lambda: ring_hybrid_gcn_forward_bodies(tiles, hrings, ws, h)), stats=rtp.stats())
        x = torch.from_numpy(normal_features(n, BENCH_DIMS[2], seed=6)).to(dev)
        att = torch.from_numpy(normal_features(n, 2, seed=7) * 0.3).to(dev)
        reset_counts()
        got = ring_hybrid_gat_bodies(tiles, hrings, x, att)
        torch.cuda.synchronize()
        check(only_of(()), "the ring-hybrid GAT launched a kernel")
        plan = make_plan(g, "neighbor_grouping", block_size=GATHER_BLOCK).to(dev)
        out["ring_hybrid_gat"] = dict(
            max_err=close_to(got, gat_aggregate(plan, x, att), "ring-hybrid GAT vs the single-card gat_aggregate"),
            ms=cuda_time_ms(lambda: ring_hybrid_gat_bodies(tiles, hrings, x, att)))
        del rtp, hring, tiles, hrings, single, plan
        agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK,
                                         pack=1, device=dev, **SCHEDULE)
        reset_counts()
        got = feature_sharded_gcn_forward_bodies(agg, ws, h, PAR_D)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        check(only_with_r1("B1", PAR_D * residual_layers(agg, layers=len(ws))) and launches == PAR_D * len(ws),
              "feature parallel: B1 and R1 not once a rank and layer")
        ref = h
        for i, w in enumerate(ws):
            ref = agg.run(ref) @ w
            ref = torch.relu(ref) if i < len(ws) - 1 else ref
        out["feature_parallel"] = dict(
            max_err=close_to(got, ref, "feature-parallel GCN vs the single-card aggregate-first forward"),
            launches=launches, ms=cuda_time_ms(lambda: feature_sharded_gcn_forward_bodies(agg, ws, h, PAR_D)))
    log("  " + ", ".join(f"{k} {v['ms']:.3f} ms" for k, v in out.items()))
    return out


def parallel_phases(g, h0, gen) -> dict:
    """Phases 51-54 (module doc)."""
    dev = h0.device
    ag = allgather_phase(g, h0, gen)
    torch.cuda.empty_cache()
    world = nccl_world_phase(dev)
    torch.cuda.empty_cache()
    arxiv = arxiv_phase(world.pop("params"), gen)
    torch.cuda.empty_cache()
    rf = ring_feature_phase(gen, dev)
    torch.cuda.empty_cache()
    return dict(allgather=ag, nccl_world=world, arxiv=arxiv, ring=rf)


# ---- phases 55-57: the figure harness (gnn_computing_tpu_torch/benchmarks)
FIG_QUICK_ITERS = 4  # phase 55: every figure's main() at --quick
FIG_ITERS = 8  # phases 56 and 57: chains of 8 and 16 calls at the real sizes
FIG_MID = "rmat_mid"  # phase 56: fig7, fig8, fig10 and fig11 (comm_mid: fig7's label-propagation route)
# phase 56's fig9 graph: over rmat_mid its two cluster orders alone take
# about as long as the rest of the phase (host seconds), so fig9 runs on
# the arxiv-scale RMAT
FIG9_DATASET = "rmat_arxiv"
DECOMPOSE_REPS = 3  # profiling.decompose's default
FIGURES = {  # module name: (module, its rows' tags, the kernels each run of it must launch)
    "fig7_models": (fig7_models, ("fig7",), ("B1", "B2")),
    "fig8_balance": (fig8_balance, ("fig8",), ("B1",)),
    "fig9_locality": (fig9_locality, ("fig9",), ("B1",)),
    "fig10_fusion": (fig10_fusion, ("fig10a", "fig10b", "fig10b_pallas"), ("B1", "B1_epilogue")),
    "fig11_sage": (fig11_sage, ("fig11",), ()),
}
FIG_ROW_TAGS = [t for _, tags, _ in FIGURES.values() for t in tags]


def fig_counts() -> dict:
    """counts() with B1's w_epilogue launches apart."""
    return dict(counts(), B1_epilogue=cuda_bcsr.epilogue_launches)


def chained_calls(iters: int, reps: int = 2) -> int:
    """Calls utils.timing.benchmark_chained makes of its function: chains of
    iters and 2 iters to warm up, then reps of each."""
    return iters * (3 + 3 * reps)


def launches_of(what: str, inputs, ctx) -> dict:
    """What one call of a harness's timed function launches: B1 3 times a
    GCN forward and B2 3 times a fast GAT forward (stabilize=False: no B5),
    one a layer over each tile part; B1 once a part a hybrid pass (fig8's
    hybrid row, fig9's hybrid_spmm over its one tile plan, fig10b_pallas:
    the fused call through the w_epilogue); R1 once a hybrid aggregation
    whose residual rows are float32 and whose residual plan has a task
    (fig7's GCN: its float32-row layers; fig10b_pallas's fused call adds
    its residual with the ATen loop); nothing on the gather path or the
    LSTM."""
    agg = ctx.get("agg")
    parts = len(agg.tile_parts()) if agg is not None else 0
    r1 = 0 if agg is None else residual_layers(agg, layers=1)
    rp = inputs[2] if what == "fig9.hybrid" else None
    want = {
        "fig7.GCN": {"B1": 3 * parts, "R1": 0 if agg is None else residual_layers(agg, ctx.get("opts"))},
        "fig7.GAT": {"B2": 3 * parts}, "fig8.hybrid": {"B1": parts, "R1": r1},
        "fig9.hybrid": {"B1": 1, "R1": int(rp is not None and rp.num_tasks_padded > 0)},
        "fig10b_pallas.split": {"B1": parts, "R1": r1},
        "fig10b_pallas.fused": {"B1": parts, "B1_epilogue": parts},
    }.get(what, {})
    return {k: v for k, v in want.items() if v}


def hybrid_edges(g, agg) -> tuple:
    """gcn_edges' lists for a hybrid aggregator on the card: the graph's
    (dst, src), the residual's from its plan's valid slots and every tile
    part's cells; checks that cells and residual partition the graph's
    edges (an unweighted graph: counts per row)."""
    plan = agg.plan
    valid = plan.slot_mask().reshape(-1)
    r_src = plan.src_flat()[valid].long()
    r_dst = plan.dst.long().repeat_interleave(plan.block_size)[valid]
    c_dst, c_src, c_cnt = (torch.cat(c) for c in zip(*(tile_cells(p) for p in agg.tile_parts())))
    g_dst, g_src = edge_lists(g, c_dst.device)
    n = g.num_nodes
    per_row = torch.bincount(c_dst, weights=c_cnt, minlength=n) + torch.bincount(r_dst, minlength=n)
    check(torch.equal(per_row.long().cpu(), torch.from_numpy(g.degrees.astype(np.int64))),
          "tile cells + residual slots do not partition the graph's edges")
    return g_dst, g_src, None, r_dst, r_src, None, c_dst, c_src, c_cnt


def figure_oracle(what: str, out: torch.Tensor, inputs, ctx) -> int:
    """Phase 56: one output of a timed function against its float64 oracle,
    with the tolerance of the phase that checks the path: the GCN layers
    against the oracle of their numeric modes (phase 3's gcn_gates, the
    misses beyond the modes' own as phase 48 counts them), the fast GAT
    forward's layers against the softmax over each row's in-edges (phase
    6), the LSTM against its float64 recurrence (float16 gates: the oracle
    of their rounding, phase 44), every other (A @ h, its product with W,
    the 10a attention aggregation) against the float64 edge-list sum with 0
    elements off the gate (phases 27 and 41).  Returns the elements off."""
    if what == "fig7.GCN":
        agg = ctx["agg"]
        gcn_gates(agg, inputs[2], ctx["opts"], inputs[0], out, hybrid_edges(ctx["graph"], agg), f"{what}: ",
                  pure="beyond_modes")
        return 0
    if what == "fig7.GAT":
        gat_gates(ctx["agg"], inputs[2], inputs[0], out, ctx["graph"], f"{what}: ", dot_mode="exact")
        return 0
    if what == "fig7.SAGE-LSTM" or what.startswith("fig11."):
        x, params, nbr = inputs
        ref = lstm_oracle(params, x, nbr)
        if ctx.get("gate_gather_dtype") is not None:
            f16_gates(params, x, nbr, out, ref, what)
            return 0
        bad = relative_error_count(out, ref)
        log(f"  {what} vs f64 recurrence: gate_bad={bad} of {ref.numel()}")
        check(bad == 0, f"{what} fails the gate against the f64 recurrence")
        return bad
    g_dst, g_src = edge_lists(ctx["graph"], out.device)
    h64 = inputs[0].double()
    if what.startswith("fig10a."):
        ref, label = gat_edge_oracle(h64, inputs[2].double(), g_dst, g_src), "f64 softmax aggregation"
    elif what.startswith("fig10b"):
        ref, label = edge_sum(h64, g_dst, g_src) @ inputs[2].double(), "f64 (A @ h) @ W"
    else:
        ref, label = edge_sum(h64, g_dst, g_src), "f64 A @ h"
    bad = relative_error_count(out, ref)
    log(f"  {what} vs {label}: gate_bad={bad} of {ref.numel()}")
    check(bad == 0, f"{what} fails the gate against the {label}")
    return bad


class FigureCheck:
    """The harness's check hook (benchmarks.common.bench; one a figure run):
    one call of each timed function, whose launches must be launches_of's
    and, with ``oracles``, whose output is held to figure_oracle; then the
    function to time, wrapped so every call adds its launches to
    ``expected``.  fig8's hybrid row adds profiling.decompose's two phases
    that run B1 (dense and total), each over its chained calls."""

    def __init__(self, iters: int, oracles: bool):
        self.iters, self.oracles = iters, oracles
        self.expected, self.per_call, self.calls = {}, {}, {}

    def add(self, launches: dict, times: int = 1):
        for k, v in launches.items():
            self.expected[k] = self.expected.get(k, 0) + v * times

    def __call__(self, what, fn, inputs, ctx):
        before = fig_counts()
        with torch.no_grad():
            out = fn(*inputs)
        torch.cuda.synchronize()
        one = {k: v - before[k] for k, v in fig_counts().items() if v != before[k]}
        want = launches_of(what, inputs, ctx)
        check(one == want, f"{what}: one call launched {one}, expected {want}")
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
        self.add(one)
        self.per_call[what] = one
        if what == "fig8.hybrid":  # decompose's dense and total phases: R1 in the total alone
            self.add({k: v * (1 if k == "R1" else 2) for k, v in one.items()}, chained_calls(self.iters, DECOMPOSE_REPS))
        if self.oracles:
            mid = fig_counts()
            with torch.no_grad():
                figure_oracle(what, out, inputs, ctx)
            torch.cuda.synchronize()
            self.add({k: v - mid[k] for k, v in fig_counts().items()})  # the gates' own forwards
        self.calls.setdefault(what, 0)

        def counted(*args):
            self.calls[what] += 1
            self.add(one)
            return fn(*args)

        return counted


def figure_rows(results: str, tags, card: str) -> dict:
    """{tag: rows} of a results directory: every row parses, names the card
    and its power limit, and every time in it is finite and > 0."""
    rows = {}
    for tag in tags:
        path = f"{results}/{tag}.jsonl"
        with open(path) as fh:
            rows[tag] = [json.loads(line) for line in fh if line.strip()]
        check(bool(rows[tag]), f"{tag}: no rows")
        for r in rows[tag]:
            check(r.get("device") == card, f"{tag}: row device {r.get('device')!r} is not {card!r}")
            times = [v for k, v in r.items() if (k.endswith("_s") and k != "ts") or k == "seconds"]
            check(bool(times) and all(math.isfinite(t) and t > 0 for t in times),
                  f"{tag}: a time is not finite and > 0: {r}")
    return rows


def run_figure(name: str, hook: FigureCheck, drive) -> dict:
    """drive() (a figure run through ``hook``) with every count set to 0
    just before and read just after: the counts must be what the hook
    expected, each of the figure's kernels launched and no other.  Returns
    the counts."""
    reset_counts()
    drive()
    torch.cuda.synchronize()
    got = {k: v for k, v in fig_counts().items() if v}
    want = {k: v for k, v in hook.expected.items() if v}
    log(f"  {name}: launches {got} (one call: {hook.per_call}; timed calls {hook.calls})")
    check(got == want, f"{name}: launches {got}, the timed calls account for {want}")
    kernels = FIGURES[name][2]
    check(all(got.get(k, 0) > 0 for k in kernels), f"{name}: a kernel of the path did not launch")
    # R1 launches wherever a hybrid pass has float32 residual rows and a
    # residual task, which launches_of counts exactly (checked above)
    check(set(got) <= {*kernels, "R1"}, f"{name}: a kernel outside {kernels} and R1 launched")
    return got


def quick_figures_phase(card: str, results: str) -> dict:
    """Phase 55: every figure's main() at --quick (rmat_quick), --iters 4."""
    log(f"phase 55: every figure's main() at --quick, --iters {FIG_QUICK_ITERS}, into a temporary results directory")
    out = {}
    for name, (mod, _, _) in FIGURES.items():
        t0 = time.perf_counter()
        hook = FigureCheck(FIG_QUICK_ITERS, oracles=False)
        got = run_figure(name, hook, lambda: mod.main(
            ["--quick", "--iters", str(FIG_QUICK_ITERS), "--results-dir", results], check=hook))
        out[name] = dict(launches=got, seconds=time.perf_counter() - t0)
    return dict(runs=out, rows=figure_rows(results, FIG_ROW_TAGS, card))


def timed_reorders():
    """fig9's reorder functions wrapped to log their host seconds."""
    stack = contextlib.ExitStack()
    secs = {}

    def timer(orig):
        def wrapped(g, **kw):
            t0 = time.perf_counter()
            out = orig(g, **kw)
            secs[orig.__name__] = time.perf_counter() - t0
            log(f"  {orig.__name__} over n={g.num_nodes} m={g.num_edges}: {secs[orig.__name__]:.2f} s (host)")
            return out
        return wrapped

    for fn in ("degree_sort", "label_propagation_reorder", "cluster_reorder", "cluster_reorder_exact"):
        stack.enter_context(patched(fig9_locality, fn, timer))
    return stack, secs


def real_figures_phase(card: str, results: str) -> dict:
    """Phase 56: one real dataset a figure (SYN_DATASETS), every timed
    function's output held to its float64 oracle before it is timed."""
    log(f"phase 56: one real dataset a figure: {FIG_MID} (fig7, fig8, fig10, fig11), comm_mid (fig7's "
        f"label-propagation route), {FIG9_DATASET} (fig9); --iters {FIG_ITERS}, outputs against float64 oracles")
    builds, out = {}, {}
    graphs = {}
    for ds in (FIG_MID, "comm_mid", FIG9_DATASET):
        args = fig_common.parse_args(fig_common.parser(""), ["--only", ds])
        t0 = time.perf_counter()
        graphs[ds] = next(fig_common.datasets(args))[1]
        builds[ds] = time.perf_counter() - t0
        log(f"  {ds}: n={graphs[ds].num_nodes} m={graphs[ds].num_edges} built in {builds[ds]:.2f} s (host)")
    runs = [("fig7_models", FIG_MID), ("fig7_models", "comm_mid"), ("fig8_balance", FIG_MID),
            ("fig9_locality", FIG9_DATASET), ("fig10_fusion", FIG_MID), ("fig11_sage", FIG_MID)]
    reorder_s = {}
    for name, ds in runs:
        mod = FIGURES[name][0]
        hook = FigureCheck(FIG_ITERS, oracles=True)
        args = fig_common.parse_args(mod.arg_parser(), ["--iters", str(FIG_ITERS), "--results-dir", results], hook)
        t0 = time.perf_counter()

        def drive():
            if mod is fig9_locality:
                stack, secs = timed_reorders()
                with stack:
                    mod.run(ds, graphs[ds], args)
                reorder_s.update(secs)
            else:
                mod.run(ds, graphs[ds], args)

        got = run_figure(name, hook, drive)
        out[f"{name}:{ds}"] = dict(launches=got, seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()
    del graphs
    rows = figure_rows(results, FIG_ROW_TAGS, card)
    return dict(runs=out, rows=rows, graph_build_s=builds, fig9_reorder_s=reorder_s)


def scaling_phase(card: str, results: str, dev) -> dict:
    """Phase 57: scaling.py at d = 1 on the card (an NCCL world of one),
    the ring hybrid and --allgather at the defaults (n = 65,536,
    m = 4,194,304, f = 32), each rank's output within PAR_TOL of the
    single-card schedule_hybrid forward; B1 in the all-gather's rank on
    every call, none in the ring's."""
    log(f"phase 57: scaling.py at d = 1 (NCCL world of one), ring hybrid and --allgather, --iters {FIG_ITERS}")
    out, graphs = {}, {}
    for path in ("ring", "allgather"):
        seen = {}

        def hook(what, fn, inputs, ctx, seen=seen):
            seen.update(what=what, out=fn(), ctx=ctx)

        t0 = time.perf_counter()
        fig_scaling.main(["--iters", str(FIG_ITERS), "--results-dir", results]
                         + (["--allgather"] if path == "allgather" else []), check=hook)
        secs = time.perf_counter() - t0
        ctx = seen["ctx"]
        r0 = ctx["ranks"][0]
        check(seen["what"] == f"scaling.{path}" and ctx["devices"] == 1 and len(ctx["ranks"]) == 1,
              f"scaling {path}: not one world of one")
        n, m = ctx["n"], ctx["m"]
        check(r0["n_pad"] == n, f"scaling {path}: the default graph should need no padding")
        if (n, m) not in graphs:
            graphs[(n, m)] = rmat_graph(n, m, seed=123, with_val=False)
        g = graphs[(n, m)]
        h = torch.from_numpy(normal_features(n, ctx["feature_len"], seed=1) * 0.1).to(dev)
        if path == "ring":
            single = Aggregator.schedule_hybrid(g, tile_rows=128, tile_cols=128, threshold=ctx["threshold"],
                                                residual_block=8, with_transpose=False, pack=1, device=dev)
        else:
            single = Aggregator.schedule_hybrid(g, tile_rows=256, tile_cols=128,
                                                threshold=max(ctx["threshold"] // 2, 4), residual_block=4,
                                                tile_dtype=np.int8, bit_tiles=True, with_transpose=False, pack=1,
                                                device=dev)
        with torch.no_grad():
            err = close_to(seen["out"].to(dev), single.run(h), f"scaling {path} d=1 vs the single-card schedule_hybrid")
        calls = 1 + chained_calls(FIG_ITERS)
        log(f"  scaling {path}: rank 0's B1 launches {r0['launches']} ({r0['launches_per_call']} a call, "
            f"{calls} calls); {secs:.1f} s with the world's start")
        if path == "ring":
            check(r0["launches"] == 0, "the ring hybrid launched B1")
        else:
            check(r0["launches_per_call"] > 0 and r0["launches"] == r0["launches_per_call"] * calls,
                  "the all-gather rank did not launch B1 on every call")
        out[path] = dict(max_err=err, launches=r0["launches"], launches_per_call=r0["launches_per_call"],
                         seconds=secs)
        del single, h
        torch.cuda.empty_cache()
    rows = figure_rows(results, ("scaling",), card)["scaling"]
    check([(r["devices"], r.get("path", "ring"), r["representative"]) for r in rows]
          == [(1, "ring", True), (1, "allgather", True)], "scaling: not one representative row a path")
    return dict(runs=out, rows=rows)


def figure_phases(card: str, dev) -> dict:
    """Phases 55-57 (module doc), each into its own temporary results
    directory; their seconds."""
    out, secs = {}, {}
    phases = (("quick", lambda r: quick_figures_phase(card, r)), ("real", lambda r: real_figures_phase(card, r)),
              ("scaling", lambda r: scaling_phase(card, r, dev)))
    for key, phase in phases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="gnn_figures_") as results:
            out[key] = phase(results)
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = dict(secs, total=sum(secs.values()))
    log(f"  phases 55-57: {out['seconds']}")
    return out


ENTRY_FORWARDS = 5  # phase 58: entry()'s forwards on the card
BENCH_ITERS = 4  # phase 58: the bench runs' --iters
# phase 58: (run, flags, metric at --quick (bench.py's names), launches of
# one timed call per tile part: forward parts "p", transposed parts "t")
BENCH_RUNS = (
    ("gcn", [], "gcn3_quick_scale_edges_per_s_per_chip", {"B1": {"p": 3}}),
    ("gat", ["--model", "gat"], "gat3_quick_scale_edges_per_s_per_chip", {"B2": {"p": 3}}),
    ("sddmm", ["--model", "sddmm"], "sddmm_quick_scale_edges_per_s_per_chip", {"B6": {"p": 1}}),
    ("gcn_train", ["--train"], "gcn3_train_quick_scale_step_agg_passes_edges_per_s_per_chip",
     {"B1": {"p": 3, "t": 3}}),
    ("gat_train", ["--train", "--model", "gat"], "gat3_train_quick_scale_step_agg_passes_edges_per_s_per_chip",
     {"B2": {"p": 3}, "B3": {"p": 3}, "B4": {"t": 3}}),
)


def entry_phase(dev) -> dict:
    """Phase 58a: entry()'s forward on the card, ENTRY_FORWARDS times: B1
    twice a layer (the 1-bit and the int8 part), no other kernel; each
    layer against the float64 oracle of its (exact) modes and the chain
    against the pure oracle, as phase 3; its time."""
    log(f"phase 58: entry() on the card ({ENTRY_FORWARDS} forwards), then python -m gnn_computing_tpu_torch.bench "
        f"--quick --iters {BENCH_ITERS} as subprocesses: {', '.join(r for r, *_ in BENCH_RUNS)}")
    fn, (agg, params, h) = port_entry.entry(dev)
    parts = len(agg.tile_parts())
    check(parts == 2 and agg.tile_bits is not None and agg.tile.pack == agg.tile_bits.pack == 8,
          "entry(): not a 1-bit and an int8 part padded to 8")
    with torch.no_grad():
        reset_counts()
        for _ in range(ENTRY_FORWARDS):
            out = fn(agg, params, h)
        torch.cuda.synchronize()
        launches, bits = cuda_bcsr.launches, cuda_bcsr.bits_launches
        check(only_with_r1("B1", ENTRY_FORWARDS * residual_layers(agg, layers=len(params))),
              "entry()'s forward launched another kernel, or R1 not once a layer")
        check(launches == 3 * parts * ENTRY_FORWARDS and bits == 3 * ENTRY_FORWARDS,
              f"entry(): B1 launched {launches} times ({bits} 1-bit) in {ENTRY_FORWARDS} forwards")
        check(out.shape == (port_entry.GRAPH[0], port_entry.DIMS[-1]) and bool(torch.isfinite(out).all()),
              "entry() output")
        g = rmat_graph(*port_entry.GRAPH, seed=123, with_val=False)
        gcn_gates(agg, params, [LayerOpts()] * len(params), h, out, hybrid_edges(g, agg), "entry: ")
        ms = cuda_time_ms(lambda: fn(agg, params, h))
    log(f"  entry forward: {ms:.3f} ms; B1 {launches} launches ({bits} 1-bit) in {ENTRY_FORWARDS} forwards")
    return dict(launches=launches, bits_launches=bits, launches_per_forward=3 * parts, forward_ms=ms,
                tiles=[p.num_tiles for p in agg.tile_parts()])


def bench_runs_phase() -> dict:
    """Phase 58b: python -m gnn_computing_tpu_torch.bench --quick for each
    of BENCH_RUNS, all at once (each process takes seconds to start, and
    each run starts three: the orchestrator, its build child, its timed
    child), each into a temporary cache directory and capture log of its
    own: exit 0, the first stdout line bench.py's metric with a finite
    value > 0, and the capture row's kernel launches (counted by the timed
    child just before and after its timed run) exactly the timed calls
    times each call's launches, every kernel of the path launched.  Their
    times are taken with the other runs on the card and host, so they are
    no measurement."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="gnn_bench_") as tmp:
        t0 = time.perf_counter()
        procs, secs = {}, {}
        try:
            for run, flags, _, _ in BENCH_RUNS:
                with open(f"{tmp}/{run}.out", "w") as fo, open(f"{tmp}/{run}.err", "w") as fe:
                    procs[run] = subprocess.Popen(
                        [sys.executable, "-m", "gnn_computing_tpu_torch.bench", "--quick", "--iters",
                         str(BENCH_ITERS), "--cache-dir", f"{tmp}/{run}", "--capture", f"{tmp}/{run}.jsonl", *flags],
                        stdout=fo, stderr=fe, start_new_session=True,
                    )
            for run, p in procs.items():
                p.wait(timeout=600)
                secs[run] = time.perf_counter() - t0
        finally:
            for p in procs.values():  # a run cut short: its children too
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        for run, _, metric, per_part in BENCH_RUNS:
            with open(f"{tmp}/{run}.out") as fo, open(f"{tmp}/{run}.err") as fe:
                stdout, stderr = fo.read(), fe.read()
            rc = procs[run].returncode
            if rc:
                log(stderr[-4000:])
            check(rc == 0, f"bench {run}: exit {rc}")
            first = json.loads(stdout.splitlines()[0])
            check(list(first) == ["metric", "value", "unit", "vs_baseline"] and first["metric"] == metric,
                  f"bench {run}: first line {first}")
            check(math.isfinite(first["value"]) and first["value"] > 0, f"bench {run}: value {first['value']}")
            with open(f"{tmp}/{run}.jsonl") as fh:
                row = json.loads(fh.read().splitlines()[-1])
            parts = {"p": row.get("tile_parts", 0), "t": row.get("tile_parts_t", 0)}
            want = {k: row["calls"] * sum(n * parts[part] for part, n in v.items()) for k, v in per_part.items()}
            check(row["launches"] == want and all(want.values()),
                  f"bench {run}: launches {row['launches']}, the timed calls account for {want}")
            check(row["device"].startswith(torch.cuda.get_device_name(0)), f"bench {run}: device {row['device']}")
            log(f"  bench {run}: {first['metric']} = {first['value']:.4g} edges/s; launches {row['launches']} over "
                f"{row['calls']} calls; done {secs[run]:.1f} s after the start")
            out[run] = dict(line=first, ms_under_load=row["time_s"] * 1e3, launches=row["launches"],
                            calls=row["calls"], tile_parts=parts["p"], tile_parts_t=parts["t"],
                            seconds=secs[run])
    return out


# bench.py --scale products's plan geometry (bench.py:1331-1350): int8
# [1024, 128] tiles at t384 split into 1-bit and int8 parts, pack 4
PRODUCTS_SCHEDULE = dict(tile_rows=1024, tile_cols=128, threshold=384)


def products_geometry_phase(g, gen) -> float:
    """Phase 58c: B1 over bench.py's products geometry (R = 1,024) on phase
    1's graph, each part at pack 1 and 4, against its plain version at
    f = 128, 64, 32 (kernel_vs_plain)."""
    tile, _ = densify(g, dtype=np.int8, **PRODUCTS_SCHEDULE)
    parts = [p for p in split_bit_tiles(tile) if p is not None and p.num_tiles]
    log(f"  B1 at R = 1,024 ([1024, 128] t384): parts {[(p.num_tiles, p.bits) for p in parts]}")
    check(len(parts) == 2, "the products geometry lacks a 1-bit or an int8 part on phase 1's graph")
    err = 0.0
    for p in parts:
        for pack in (1, 4):
            tp = p.pad_runs(pack).to(gen.device)
            for f in BENCH_DIMS[1:]:
                err = max(err, kernel_vs_plain(tp, f, "split", gen, f"R=1024 {'1-bit' if p.bits else 'int8'} pack{pack}"))
    return err


def entry_bench_phase(dev, g, gen) -> dict:
    """Phase 58 (module doc) and its seconds."""
    t0 = time.perf_counter()
    out = dict(entry=entry_phase(dev))
    out["products_geometry_max_err"] = products_geometry_phase(g, gen)
    torch.cuda.empty_cache()
    out["bench"] = bench_runs_phase()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 58: {out['seconds']:.1f} s")
    return out


# phase 59: the hybrid op's residual kernel R1 at the benchmark cells' plans:
# (label, graph (n, m), densify's geometry, whether the step also runs the
# transposed residual), as portbench/traffic/*.json give them
RESIDUAL_PLANS = (
    ("products", (2_449_029, 123_718_280), PRODUCTS_SCHEDULE, False),
    ("reddit-train", SCALES["reddit"], TRAIN_SCHEDULE, True),
)


def summation_check(got, plan, h, out, what: str) -> float:
    """``got`` (out + A_plan @ h in float32, any order of the sum) against
    the float64 result, element by element within the worst-case bound of
    a float32 sum of N + 1 terms in any order, gamma(N + 1) times the sum
    of the terms' magnitudes (N the row's residual edges; a product's FMA
    rounds with its sum).  A cell's hub rows sum tens of thousands of
    terms, many of one source row (the RMAT draws repeat an edge), where
    two float32 orders differ by more than KERNEL_TOL * max|sum|.  Returns
    max|got - float64|."""
    u = 2.0**-24
    n = torch.zeros(plan.num_nodes, dtype=torch.float64, device=h.device)
    n.index_add_(0, plan.dst, plan.count.double())
    gamma = (n + 1) * u / (1 - (n + 1) * u)
    ref = out.double() + spmm_plain(plan, h.double())
    mag = out.double().abs() + spmm_plain(plan, h.double().abs(), val=plan.val.abs())
    err = (got.double() - ref).abs()
    ok = bool((err <= gamma[:, None] * mag).all())
    worst = err.max().item()
    log(f"  {what}: max|d| vs float64 {worst:.3e} (max|float64| {ref.abs().max().item():.3e}); "
        f"within gamma(N + 1) * sum|terms| everywhere: {ok}")
    check(ok and bool(torch.isfinite(got).all()), f"{what}: off the float64 result beyond a float32 sum's bound")
    return worst


def residual_row(plan, h, out, csr, what: str) -> dict:
    """R1 over ``plan`` at h's width: one launch a call, against float64
    within a float32 sum's bound (summation_check, the plain version's
    distance printed beside it); its ms (CUDA events), device ms
    (profiler), bounds, the plain version's ms and torch.sparse.mm of the
    residual CSR (``library_ms``, a yardstick the port never calls)."""
    f = h.shape[1]
    before = cuda_residual.launches
    got = residual_spmm_(out.clone(), plan, h)
    check(cuda_residual.launches == before + 1, f"{what}: R1 did not launch once a call")
    torch.cuda.synchronize()
    err = summation_check(got, plan, h, out, f"{what} f={f} R1")
    del got
    summation_check(out + spmm_plain(plan, h), plan, h, out, f"{what} f={f} spmm_plain")
    torch.cuda.empty_cache()
    acc = out.clone()
    ms = cuda_time_ms(lambda: residual_spmm_(acc, plan, h))
    dev_ms = device_ms(lambda: residual_spmm_(acc, plan, h), expect=("residual_spmm_kernel",))
    plain_ms = cuda_time_ms(lambda: out + spmm_plain(plan, h))
    library_ms = cuda_time_ms(lambda: out + torch.sparse.mm(csr, h))
    slots, tasks, edges = plan.num_tasks_padded * plan.block_size, plan.num_tasks_padded, plan.num_edges
    distinct = int(torch.unique(plan.src[plan.slot_mask().reshape(-1)]).numel())
    index_bytes = 12 * slots + 12 * tasks  # src int64 + val float32 a slot, count int32 + dst int64 a task
    out_bytes = 2 * 4 * plan.num_nodes * f  # out read and written once
    bound_ms = (4 * edges * f + index_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    distinct_ms = (4 * distinct * f + index_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    row = dict(f=f, ms=ms, device_ms=None if dev_ms is None else dev_ms["residual_spmm_kernel"],
               bound_ms=bound_ms, distinct_bound_ms=distinct_ms, bound_by="bytes", plain_ms=plain_ms,
               library_ms=library_ms, max_abs_err=err, edges=edges, slots=slots, tasks=tasks, distinct_rows=distinct)
    log(f"  {what} f={f}: R1 {ms:.3f} ms/launch (device {row['device_ms']}) | bound {bound_ms:.3f} (edges' rows; "
        f"distinct rows {distinct_ms:.3f}) | plain {plain_ms:.3f} | torch.sparse.mm {library_ms:.3f}")
    return row


def residual_phase(dev) -> dict:
    """Phase 59: R1 at the benchmark cells' residual plans (RMAT at
    ogbn-products' and reddit's sizes, structure seed 123, degree sorted,
    densified as the cells' traffic; 4-slot neighbor grouping), the
    transposed plan where the cell trains, at f = 128, 64, 32: residual_row
    for each.  The graphs are drawn and the plans built here (host seconds,
    printed)."""
    log("phase 59: the residual kernel R1 at the benchmark cells' plans (products; reddit-train and its transpose)")
    gen = torch.Generator(device=dev).manual_seed(59)
    out = {}
    for label, (n, m), schedule, transposed in RESIDUAL_PLANS:
        t0 = time.perf_counter()
        g = rmat_graph(n, m, seed=123, with_val=False, device=dev)
        g = g.reorder(degree_sort(g))
        _, res = densify(g, dtype=np.int8, **schedule)
        del g
        graphs = [(label, res)] + ([(f"{label} transposed", res.transpose_with_map()[0])] if transposed else [])
        plans = [(name, gr, neighbor_grouping_plan(gr, block_size=RESIDUAL_BLOCK).to(dev)) for name, gr in graphs]
        log(f"  {label}: residual plans built in {time.perf_counter() - t0:.1f} s: "
            + "; ".join(f"{name} edges={p.num_edges} slots={p.num_tasks_padded * p.block_size} rows={p.num_nodes}"
                        for name, _, p in plans))
        for name, gr, plan in plans:
            check(plan.sorted_by_dst, f"{name}: the residual plan is not sorted by destination")
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(gr.indptr.astype(np.int64)), torch.from_numpy(gr.indices.astype(np.int64)),
                torch.ones(gr.num_edges), size=(gr.num_nodes, gr.n_src)).to(dev)
            rows = []
            for f in BENCH_DIMS[1:]:
                h = torch.randn((gr.n_src, f), generator=gen, device=dev)
                o = torch.randn((gr.num_nodes, f), generator=gen, device=dev)
                rows.append(residual_row(plan, h, o, csr, name))
                del h, o
            out[name] = rows
            del csr, plan
            torch.cuda.empty_cache()
    print(json.dumps({"residual": out}), flush=True)
    return out


# the published GAT's first-step gradients against the float64 reference,
# relative L2 of each leaf, gated by kind.  A projection W's gradient
# (GEMMs of float32 sums) read <= 1.9e-6 on the card over two draws, so
# 2e-5 passes no TF32-grade error.  An attention vector's gradient sums
# terms that cancel but for the edges on the kink's other side (sum_j
# alpha_ij (<g_i, z_j> - c_i) = 0 over a row whose edges all lie on one
# side): layer 2's read 1.9e-5 and 1.76e-4 on the card over two draws and
# 7.9e-5 on the CPU at n = 4,096, so a few times that; the kernels' own
# gates above hold the aggregation at 1e-5.
HEADS_W_REL_L2 = 2e-5
HEADS_A_REL_L2 = 5e-4


def heads_phase(dev) -> dict:
    """Phase 60: the published multi-head GAT's kernels, one head and the
    model on the training cells' plan at the quick scale (module doc)."""
    from portbench import spec
    from portbench.models import gat_heads as bench_heads
    from portbench.reference import common as ref_common
    from portbench.reference import gat_heads as ref_heads

    log("phase 60: the published multi-head GAT (gat-ppi) at the quick scale: B2-B4 at f = 256 and 121, one head, "
        "the model")
    gen = torch.Generator(device=dev).manual_seed(60)
    n, m = SCALES["quick"]
    t0 = time.perf_counter()
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, residual_block=RESIDUAL_BLOCK, pack=16,
                                     with_transpose=True, bit_tiles=True, device=dev, **TRAIN_SCHEDULE)
    pairs = ((agg.tile_bits, agg.tile_bits_t), (agg.tile, agg.tile_t))
    check(all(p is not None and q is not None for p, q in pairs), "the plan did not split into 1-bit and int8 parts")
    parts = len(agg.tile_parts())
    log(f"  plan built in {time.perf_counter() - t0:.1f} s: {parts} parts, residual edges {agg.plan.num_edges}")
    out = {"kernel_max_err": {}, "head": {}}
    for f in (256, 121):
        err = 0.0
        for p, p_t in pairs:
            label = f"heads {part_name(p)} part"
            err = max(err, gat_kernel_vs_plain(p, f, gen, label), bwd_kernels_vs_plain(p, p_t, f, gen, label))
        out["kernel_max_err"][f] = err

    g_dst, g_src = edge_lists(g, dev)
    for f in (256, 121):
        feat = torch.randn((n, f), generator=gen, device=dev) * 0.1  # a layer's z at the cell's scale
        att = torch.randn((n, 2), generator=gen, device=dev) * 0.5
        kink = port_kink_sides(att, agg.tile_parts(), g_dst, g_src)
        feat.requires_grad_(True)
        att.requires_grad_(True)
        ct = cotangent((n, f), dev)
        reset_counts()
        y = agg.run_gat(feat, att, stabilize="bound", dot_mode="exact")
        (y * ct.float()).sum().backward()
        torch.cuda.synchronize()
        c = counts()
        log(f"  one head f={f}: launches {c}")
        check(c["B2"] == parts and c["B3"] == parts and c["B4"] == parts and c["B5"] == 0,
              f"one head f={f}: B2, B3, B4 not once a part")
        f64 = feat.detach().double().requires_grad_(True)
        a64 = att.detach().double().requires_grad_(True)
        want = gat_edge_oracle_ad(f64, a64, g_dst, g_src, kink)
        compare(y.detach(), want.detach().float(), f"one head f={f} out vs f64", gate=True)
        (want * ct).sum().backward()
        grad_gate(feat.grad, f64.grad, f"one head f={f} dh vs f64 autograd")
        grad_gate(att.grad, a64.grad, f"one head f={f} datt vs f64 autograd")
        out["head"][f] = dict(launches=c)
        del feat, att, f64, a64, want, y, ct, kink
        torch.cuda.empty_cache()

    cfg = spec.cell("gat-ppi.reddit-train").config
    dims, heads_of = cfg["dims"], cfg["gat"]["heads"]
    leaves = bench_heads.weights(cfg, 60, dev)  # the benchmark's Glorot draw
    w0 = [w.clone() for w in leaves]
    leaves = [w.requires_grad_(True) for w in leaves]
    h0 = torch.randn((n, dims[0]), generator=gen, device=dev) * 0.1
    labels = torch.randint(0, dims[-1], (n,), generator=gen, device=dev)
    fwd = bench_heads.program(cfg, agg, leaves)
    step = make_train_step(fwd, torch.optim.Adam(leaves, lr=cfg["train"]["lr"]), device=dev)
    reset_counts()
    with profiling.recording() as rec:
        loss = float(step((h0,), labels))
    torch.cuda.synchronize()
    c = counts()
    grads = [p.grad.detach().clone() for p in leaves]
    heads = sum(heads_of)
    head_spans = sum(1 for s in rec.spans if s.name == "gnn.gat.head")
    copy = sum(n * k * f * 4 for f, k in zip(dims[1:], heads_of))
    log(f"  one step: launches {c}, gnn.gat.head spans {head_spans}, counters {rec.counters}")
    check(head_spans == heads and rec.counters.get("gat.heads") == heads
          and rec.counters.get("gat.head_copy_bytes") == copy, "the step's head spans or counters")
    check(c["B2"] == heads * parts and c["B3"] == heads * parts and c["B4"] == heads * parts,
          "B2, B3, B4 not once a head a part in a step")
    t0 = time.perf_counter()
    edges = ref_common.Edges(src=g_src, dst=g_dst, num_nodes=n)
    loss64, grads64 = ref_heads.forward_backward(cfg, edges, h0, labels, w0)
    ref_s = time.perf_counter() - t0
    rels = [rel_l2(a, b) for a, b in zip(grads, grads64)]
    log(f"  loss {loss:.9f}, float64 reference {float(loss64):.9f} ({ref_s:.1f} s); gradients' relative L2 {rels}")
    check(abs(loss - float(loss64)) <= 1e-6 * abs(float(loss64)), "the first step's loss off the float64 reference")
    check(max(rels[0::2]) <= HEADS_W_REL_L2, "a projection's gradient off the float64 reference")
    check(max(rels[1::2]) <= HEADS_A_REL_L2, "an attention vector's gradient off the float64 reference")
    del edges, grads64, g_dst, g_src
    torch.cuda.empty_cache()
    reset_counts()
    losses = [step((h0,), labels) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    c = counts()
    losses = [float(v) for v in losses]
    check(all(np.isfinite(losses)), "the published GAT's training loss not finite")
    check(c["B2"] == c["B3"] == c["B4"] == TRAIN_STEPS * heads * parts, "B2, B3, B4 not once a head a part a step")
    step_ms = cuda_time_ms(lambda: step((h0,), labels))
    log(f"  {TRAIN_STEPS} steps: losses {losses}, launches {c}; step {step_ms:.3f} ms, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    out.update(step_launches=c, losses=losses, step_ms=step_ms, rel_l2=rels, reference_s=ref_s,
               first_loss=loss, first_loss_f64=float(loss64))
    print(json.dumps({"heads": out}, default=float), flush=True)
    return out


def staged_phase(dev) -> dict:
    """Phase 61: B1's staged walk against its gather walk on the same chunk
    cuts, at the quick scale (module doc)."""
    log("phase 61: B1's staged walk at the quick scale: bitwise its gather walk, both timed")
    n, m = SCALES["quick"]
    t0 = time.perf_counter()
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    bits_t, train = split_bit_tiles(densify(g, dtype=np.int8, **TRAIN_SCHEDULE)[0])
    bits_f, fwd = split_bit_tiles(densify(g, dtype=np.int8, **SCHEDULE)[0])
    plans = {"training int8 [256, 256] t24": train.pad_runs(16).to(dev),
             "its transpose": train.transpose().pad_runs(16).to(dev),
             "forward int8 [512, 256] t48": fwd.pad_runs(16).to(dev)}
    bits = {"training 1-bit": bits_t.pad_runs(16).to(dev), "forward 1-bit": bits_f.pad_runs(16).to(dev)}
    log(f"  plans built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(61)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = {"staged": lambda real: lambda *a: True, "gather": lambda real: lambda *a: False,
            "own": lambda real: real}
    rows = []
    with torch.no_grad():
        for label, tp in plans.items():
            w = cell_walk.walk_for(tp)
            check(w.num_staged > 0, f"{label}: no chunk staged")
            row = dict(plan=label, chunks=w.num_chunks, staged_chunks=w.num_staged, staged_tiles=w.num_stage_tiles,
                       staged_cells=w.staged_cells, cells=w.total_cells, ms={}, own_stages={})
            for f in (128, 64, 32, 121, 256):
                h = torch.randn((tp.n_src, f), generator=gen, device=dev)
                wt = torch.randn((f, BENCH_DIMS[3]), generator=gen, device=dev) * 0.1
                outs, ms = {}, {}
                for path, wrap in rule.items():
                    with patched(cell_walk, "stages", wrap):
                        before = cuda_bcsr.launches
                        outs[path] = [cuda_bcsr.bcsr_spmm_cuda(tp, h)]
                        check(cuda_bcsr.launches == before + 1, f"{label} f={f} {path}: B1 not launched once")
                        if f <= 128:
                            outs[path] += list(bcsr_spmm_nn(tp, h, wt))
                        if f in BENCH_DIMS[1:]:
                            ms[path] = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, h))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) and torch.equal(a, c)
                          for a, b, c in zip(outs["staged"], outs["gather"], outs["own"])),
                      f"{label} f={f}: the staged walk differs from the gather walk")
                want = bcsr_spmm_plain(tp, h)
                compare(outs["staged"][0], want, f"{label} f={f} staged B1", gate=False)
                row["own_stages"][f] = cell_walk.stages(w, f, sms)
                if ms:
                    row["ms"][f] = ms
                    log(f"  {label} f={f}: staged {ms['staged']:.3f} ms, gather {ms['gather']:.3f} ms, "
                        f"own launch {ms['own']:.3f} ms ({'staged' if row['own_stages'][f] else 'gather'})")
            with profiling.recording() as rec, patched(cell_walk, "stages", rule["staged"]):
                cuda_bcsr.bcsr_spmm_cuda(tp, torch.randn((tp.n_src, 32), generator=gen, device=dev))
            read = (rec.counters.get("walk.staged_cells"), rec.counters.get("walk.cells"))
            check(read == (w.staged_cells, w.total_cells), f"{label}: the walk counters do not read the work list")
            rows.append(row)
            log(f"  {label}: {w.num_staged} of {w.num_chunks} chunks staged, {w.staged_cells} of {w.total_cells} "
                f"cells; bitwise equal at f = 128, 64, 32, 121, 256")
        for label, tp in bits.items():
            with profiling.recording() as rec:
                cuda_bcsr.bcsr_spmm_cuda(tp, torch.randn((tp.n_src, 32), generator=gen, device=dev))
            check(rec.counters.get("walk.staged_cells") == 0 and rec.counters.get("walk.cells", 0) > 0,
                  f"{label}: a 1-bit part staged cells")
    torch.cuda.synchronize()
    print(json.dumps({"staged": rows}), flush=True)
    return {"plans": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="quick")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- phase 1: card and build
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}  ({card})  torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for lib, secs in libs.values():
        log(f"  {lib.name}: {secs:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    build_s = libs["bcsr_spmm"][1]

    # ---- graph and plans
    n, m = SCALES[args.scale]
    t0 = time.perf_counter()
    g = rmat_graph(n, m, seed=123, with_val=False)
    g = g.reorder(degree_sort(g))
    agg = Aggregator.schedule_hybrid(g, tile_dtype=np.int8, with_transpose=False, residual_block=RESIDUAL_BLOCK, pack=1, device=dev, **SCHEDULE)
    tile_host, res_host = densify(g, dtype=np.int8, **SCHEDULE)
    tile16 = tile_host.pad_runs(16).to(dev)
    tp = agg.tile
    log(
        f"plan ({args.scale}): n={n} m={m} tiles={tp.num_tiles} (pack16: {tile16.num_tiles}) "
        f"dense_edges={tp.num_dense_edges} residual_edges={agg.plan.num_edges} "
        f"tasks={agg.plan.num_tasks} built in {time.perf_counter() - t0:.1f} s"
    )
    walk0 = walk_line(tp, f"GCN plan ({args.scale})")

    # ---- phase 2: kernel against its plain version
    log("phase 2: B1 kernel vs bcsr_spmm_plain")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for plan, label in ((tp, "pack1"), (tile16, "pack16")):
        for f in (BENCH_DIMS[1], BENCH_DIMS[2], BENCH_DIMS[3]):
            for mode in ("split", "native"):
                err = kernel_vs_plain(plan, f, mode, gen, label)
                if plan is tp:
                    max_err = max(max_err, err)
    # n not a multiple of R, and a last row-tile too sparse for any tile:
    # after pad_runs(16) its run is 16 filler tiles
    ng, rng = ragged_graph()
    sd = rng.uniform(0.2, 2.0, ng.num_nodes).astype(np.float32)
    ss = rng.uniform(0.2, 2.0, ng.n_src).astype(np.float32)
    ragged, _ = densify(
        ng, dtype=np.int8, val=sd[ng.dst_per_edge] * ss[ng.indices], scale_dst=sd, scale_src=ss, **SCHEDULE
    )
    ragged = ragged.pad_runs(16)
    filler_runs = filler_only_runs(ragged)
    check(ng.num_nodes % SCHEDULE["tile_rows"] != 0 and filler_runs, "ragged case lacks a filler-only run")
    log(f"  ragged factored plan: n={ng.num_nodes} tiles={ragged.num_tiles} filler-only runs={filler_runs}")
    ragged = ragged.to(dev)
    for f in (BENCH_DIMS[1], BENCH_DIMS[3]):
        for mode in ("split", "native"):
            kernel_vs_plain(ragged, f, mode, gen, "ragged factored")

    # ---- phase 3: the slice's main path
    log("phase 3: 3-layer GCN forward, fast_layer_opts")
    model = gcn_params_from_jax(glorot_weights(BENCH_DIMS, seed=0), device=dev)
    opts = fast_layer_opts(BENCH_DIMS)
    h0 = torch.from_numpy(normal_features(n, BENCH_DIMS[0], seed=123) * 0.1).to(dev)
    forwards = 5
    with torch.no_grad():
        reset_counts()
        for _ in range(forwards):
            out = model(agg, h0, opts)
        torch.cuda.synchronize()
        launches = cuda_bcsr.launches
        check(only_with_r1("B1", forwards * residual_layers(agg, opts)),
              "the GCN forward launched another kernel, or R1 not once a float32-row layer")
        log(f"  B1 launches in {forwards} forwards: {launches}")
        check(launches == 3 * forwards, "B1 did not launch 3 times per forward")
        check(out.shape == (n, BENCH_DIMS[-1]) and bool(torch.isfinite(out).all()), "forward output")

        edges = gcn_edges(g, res_host, tp)
        xs = gcn_gates(agg, model.weights, opts, h0, out, edges, "")
        del edges
        gcn_out = out

        # ---- phase 4: timing
        log("phase 4: timing (CUDA events, median of 10 after 3 warm-up)")
        fwd_ms = cuda_time_ms(lambda: model(agg, h0, opts))
        log(f"  forward: {fwd_ms:.3f} ms")
        csr = tile_csr(tp)
        nnz = csr.values().numel()
        shapes = []
        for i, w in enumerate(model.weights):
            layer_ms = cuda_time_ms(lambda: gcn_layer(agg, xs[i], w, opts[i]))
            x = round_h((xs[i] @ w).contiguous(), opts[i].tile_h_mode)
            f = x.shape[1]
            ms = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tp, x))
            ms16 = cuda_time_ms(lambda: cuda_bcsr.bcsr_spmm_cuda(tile16, x))
            plain_ms = cuda_time_ms(lambda: bcsr_spmm_plain(tp, x))
            library_ms = cuda_time_ms(lambda: torch.sparse.mm(csr, x))
            move = tp.a.numel() + 4 * (tp.num_tiles + tp.num_row_tiles + 1) + 4 * f * (tp.n_src + tp.num_nodes)
            bytes_ms = move / HBM_BYTES_PER_S * 1e3
            ops_ms = 2.0 * nnz * f / FP32_FLOPS * 1e3
            stream_ms = (tp.a.numel() + 4.0 * tp.num_tiles * tp.tile_cols * f) / HBM_BYTES_PER_S * 1e3
            row = dict(
                f=f, layer_ms=layer_ms, ms=ms, ms_pack16=ms16, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                tile_stream_ms=stream_ms, tiles=tp.num_tiles, nnz_cells=nnz,
            )
            shapes.append(row)
            log(
                f"  layer {i + 1} f={f}: layer {layer_ms:.3f} ms | B1 {ms:.3f} ms/launch "
                f"(pack16 {ms16:.3f}) bound {row['bound_ms']:.4f} ms ({row['bound_by']}; tile stream "
                f"{stream_ms:.4f}) | plain {plain_ms:.3f} | torch.sparse.mm {library_ms:.3f}"
            )

    res_plan = agg.plan
    del agg, tp, tile16, model, xs, csr
    torch.cuda.empty_cache()
    gat_kernels, gat_out = gat_phases(args, g, h0, gen, forwards, libs)
    torch.cuda.empty_cache()
    train = None
    if args.scale == "quick":
        train = train_phases(args, g, h0, gen)
    else:
        log("phases 8-11 (training) run at the quick scale only")
    torch.cuda.empty_cache()
    sdd = sddmm_phases(args, g, gen)
    torch.cuda.empty_cache()
    bt = bits_gcn_phase(g, h0, tile_host, res_host, res_plan, gcn_out, forwards, gen)
    b6, b1_bits = timing_phase(g, sdd, bt)
    b6.update(launches=sdd["launches"], parts=len(sdd["agg"].tile_parts()), max_err=sdd["max_err"])
    b1_bits.update(launches=bt["launches"], max_err=bt["max_err"])
    del sdd, bt
    torch.cuda.empty_cache()
    if train is not None:
        bits_train = bits_train_phases(args, g, h0, gen, train, gat_out, forwards)
        torch.cuda.empty_cache()
        fl = float_phases(g, h0, gen, gcn_out, forwards)
        torch.cuda.empty_cache()
        repair = repair_phase(g, gen)
        torch.cuda.empty_cache()
        fg = float_gat_phases(g, h0, gen, forwards)
        torch.cuda.empty_cache()
        modes = mode_phases(g, h0, gen, forwards)
        torch.cuda.empty_cache()
        pr = probe_phase(g, gen)
        torch.cuda.empty_cache()
        walk = walk_phase(g, gen)
        torch.cuda.empty_cache()
        rd = rowmax_dad_phase(g, gen)
        torch.cuda.empty_cache()
        dd = dh_das_sddmm_phase(g, gen)
        torch.cuda.empty_cache()
        gather, gather_aggs = gather_phases(g, h0, gen)
        torch.cuda.empty_cache()
        sage, edgemlp = sage_edgemlp_phases(g, gather_aggs, dev)
        del gather_aggs
        torch.cuda.empty_cache()
        reorders = reorder_phase(h0, forwards)
        torch.cuda.empty_cache()
        cli_out = cli_phase()
        torch.cuda.empty_cache()
        dec = decompose_phase(g, gen, shapes, gat_kernels[0]["shapes"], dev)
        torch.cuda.empty_cache()
        par = parallel_phases(g, h0, gen)
        torch.cuda.empty_cache()
        figs = figure_phases(card, dev)
        torch.cuda.empty_cache()
        eb = entry_bench_phase(dev, g, gen)
        torch.cuda.empty_cache()
        r1 = residual_phase(dev)
        torch.cuda.empty_cache()
        heads_phase(dev)
        torch.cuda.empty_cache()
        staged_phase(dev)
    else:
        reddit_train = bits_train_reddit_phase(g, h0)
        torch.cuda.empty_cache()
        gather, ng_reddit = gather_reddit_phase(g, h0)
        torch.cuda.empty_cache()
        sage, edgemlp = sage_edgemlp_reddit_phase(g, ng_reddit, dev)
        del ng_reddit
        log("phases 22-39 (float tiles, the fused aggregate+GEMM, the repairs, GAT and SDDMM over float tiles, "
            "B2's other modes, the residual probe, the cell walk's checks, B3, B5 and B4 on the walk, B6 streamed) "
            "run at the quick scale only")

    # ---- phase 21: report
    total = lambda k: sum(r[k] for r in shapes)  # noqa: E731
    kernels = [dict(
        name="bcsr_spmm",
        route="cuda",
        source="gnn_computing_tpu_torch/csrc/bcsr_spmm.cu",
        replaces="gnn_computing_tpu/ops/pallas_bcsr.py:180",
        launches=launches,
        max_abs_err=max_err,
        # times summed over the three launches of one forward (f=128, 64, 32)
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in shapes) else "operations",
        library_ms=total("library_ms"), walk="cell", walk_plan=walk0,
        forward_ms=fwd_ms, build_s=build_s, scale=args.scale, shapes=shapes,
    )] + gat_kernels

    def summed(rows, **extra):
        # times summed over the rows' launches (the three layers of one step
        # or forward; the parts of one SDDMM call)
        return dict(
            ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
            library_ms=sum(r["library_ms"] for r in rows), shapes=rows, **extra,
        )

    kernels[0]["bits"] = dict(
        path="GCN forward over phase 3's plan split into 1-bit and int8 parts (fast_layer_opts)",
        launches=b1_bits["launches"], launches_per_forward=6, max_abs_err=b1_bits["max_err"],
        forward_ms=b1_bits["forward_ms"], **summed(b1_bits["rows"], over="the 1-bit part, f=128, 64, 32"),
    )
    if train is not None:
        rows, tt = train["rows"], train["times"]
        kernels[0]["training"] = dict(
            path=f"GCN training step (B1 forward and over the transposed plan), {TRAIN_STEPS} steps",
            launches=train["gcn_counts"]["B1"], launches_per_step=6, max_abs_err=train["max_err"]["B1_t"],
            step_ms=tt["gcn_step_ms"], **summed(rows["B1_t"], over="transposed [256, 256] plan"),
        )
        kernels[1]["training"] = dict(
            path=f"GAT training step, {TRAIN_STEPS} steps", launches=train["gat_counts"]["B2"], launches_per_step=3,
            max_abs_err=train["max_err"]["B2"], step_ms=tt["gat_step_ms"], **summed(rows["B2"], over="[256, 256] plan"),
        )
        for kname, key, replaces in (
            ("gat_bwd_dad", "B3", "gnn_computing_tpu/ops/pallas_bcsr.py:869"),
            ("gat_bwd_dh_das", "B4", "gnn_computing_tpu/ops/pallas_bcsr.py:1045"),
        ):
            kernels.append(dict(
                name=kname, route="cuda", source=f"gnn_computing_tpu_torch/csrc/{kname}.cu", replaces=replaces,
                launches=train["gat_counts"][key], launches_per_step=3, max_abs_err=train["max_err"]["B3"],
                **summed(rows[key]), path=f"GAT training step (fast=False, stabilize='bound', split2), {TRAIN_STEPS} steps",
                step_ms=tt["gat_step_ms"], build_s=libs[kname][1], scale=args.scale,
            ))
        # bit-tile training (phases 16-20): times over the 1-bit parts, the
        # int8 parts' beside them
        bits = bits_train
        bt_times = bits["times"]
        step_path = f"bit-tile training step (1-bit and int8 parts with their transposes), {TRAIN_STEPS} steps"
        kernels[0]["training"]["bits"] = dict(
            path=f"GCN {step_path}", launches=bits["gcn_counts"]["B1"], bits_launches=bits["gcn_bits"]["B1"],
            launches_per_step=12, max_abs_err=bits["max_err"]["B1_t"], step_ms=bt_times["gcn_step_ms"],
            forward_ms=bt_times["gcn_forward_ms"], backward_adam_ms=bt_times["gcn_backward_adam_ms"],
            int8_step_ms=tt["gcn_step_ms"], plan_build_s=bits["build_s"],
            int8_part=summed(bits["rows_i"]["B1_t"], over="int8 part of the transposed plan"),
            **summed(bits["rows_b"]["B1_t"], over="1-bit part of the transposed [256, 256] plan"),
        )
        kernels[1]["bits"] = dict(
            path=f"GAT {step_path}; 1-bit GAT forward (fast, split2)", launches=bits["gat_counts"]["B2"],
            bits_launches=bits["gat_bits"]["B2"], launches_per_step=6, max_abs_err=bits["max_err"]["B2"],
            step_ms=bt_times["gat_step_ms"], int8_step_ms=tt["gat_step_ms"],
            forward_launches=bits["fwd_counts"][0], forward_bits_launches=bits["fwd_counts"][1],
            forward_ms=bits["forward_ms"], int8_forward_ms=kernels[1]["forward_ms"],
            int8_part=summed(bits["rows_i"]["B2"], over="int8 part of the [256, 256] plan"),
            **summed(bits["rows_b"]["B2"], over="1-bit part of the [256, 256] plan"),
        )
        kernels[2]["bits"] = dict(
            path="1-bit GAT forward (fast, split2, stabilize=True)", launches=bits["stab_counts"][0],
            bits_launches=bits["stab_counts"][1], launches_per_forward=6, max_abs_err=0.0,
            forward_ms=bits["stab_ms"], int8_forward_ms=kernels[2]["forward_ms"],
            int8_part=summed(bits["rows5_i"], over="int8 part of the [512, 256] t32 plan"),
            **summed(bits["rows5"], over="1-bit part of the [512, 256] t32 plan"),
        )
        for k, key in ((kernels[-2], "B3"), (kernels[-1], "B4")):
            k["bits"] = dict(
                path=f"GAT {step_path}", launches=bits["gat_counts"][key], bits_launches=bits["gat_bits"][key],
                launches_per_step=6, max_abs_err=bits["max_err"]["B3"], step_ms=bt_times["gat_step_ms"],
                int8_part=summed(bits["rows_i"][key], over="int8 part"),
                **summed(bits["rows_b"][key], over="1-bit part"),
            )
        # float tiles and the fused aggregate+GEMM (phases 22-27)
        ft = fl["times"]
        kernels[0]["float"] = dict(
            path="paths 1-3: weighted GCN forward (gcn_norm_val, float32 tiles) and its training steps; "
                 "bench.py --tile-dtype bf16 forward; the updateval chain (hybrid_sddmm -> tileplan_with_values)",
            launches=fl["fwd_counts"][1], launches_per_forward=3, training_launches=fl["train_float"],
            launches_per_step=6, bf16_launches=fl["bf16_counts"][1], chain_launches=fl["chain_counts"]["B1"],
            max_abs_err=max(fl["max_err"]["f32"], fl["max_err"]["bf16"]), bf16_max_abs_err=fl["max_err"]["bf16"],
            forward_ms=ft["weighted_forward_ms"], step_ms=ft["weighted_step_ms"], bf16_forward_ms=ft["bf16_forward_ms"],
            chain_ms=ft["chain_ms"], plan_build_s=fl["build_s"], losses=fl["train_losses"],
            bf16=summed(fl["rows_bf16"], over="bfloat16 count tiles [512, 256] t48, f=128, 64, 32"),
            transposed=summed(fl["rows_t"], over="transposed float32 tiles, f=128, 64, 32"),
            chain=summed(fl["rows_chain"], over="the updateval chain's float32 tiles, f=32"),
            **summed(fl["rows_f32"], over="float32 tiles [512, 256] t48 (gcn_norm_val), f=128, 64, 32"),
        )
        kernels[0]["epilogue"] = dict(
            path=f"hybrid_spmm_nn over fig10b_pallas's schedule (int8 [256, 128] t24, residual "
                 f"{RESIDUAL_BLOCK}), f={FUSED_F}, W [{FUSED_F}, {FUSED_F}]; {FUSED_CALLS} calls",
            launches=fl["fused_counts"][1], launches_per_call=len(fl["rows_epi"]),
            max_abs_err=fl["max_err"]["epilogue"], fused_ms=ft["fused_ms"], split_ms=ft["split_ms"],
            **summed(fl["rows_epi"], over="int8 [256, 128] t24, (f, f_out) = (32, 32)"),
        )
        # GAT and SDDMM over float tiles (phases 29-33): the float32 and
        # bfloat16 entry points of B2-B5 here, B6's below
        gt, tf, tb_ = fg["T_f32"], fg["T_f32"]["train"], fg["T_bf16"]["train"]
        kernels[1]["float"] = dict(
            path="G1: GAT forward over the JAX default schedule (float32 count tiles [256, 128], default threshold, "
                 "residual 8), fast, split2; G2: bench.py --model gat --tile-dtype bf16 (bfloat16 [512, 256] t32)",
            launches=fg["G1"]["launches"], launches_per_forward=3, bf16_launches=fg["G2"]["launches"],
            training_launches=fg["T_f32"]["float_counts"]["B2"], bf16_training_launches=fg["T_bf16"]["float_counts"]["B2"],
            max_abs_err=fg["max_err"]["B2_f32"], bf16_max_abs_err=fg["max_err"]["B2_bf16"],
            forward_ms=fg["G1"]["forward_ms"], bf16_forward_ms=fg["G2"]["forward_ms"],
            bf16=summed(fg["G2"]["rows2"], over="G2 bfloat16 [512, 256] t32, f=128, 64, 32"),
            **summed(fg["G1"]["rows2"], over="G1 float32 [256, 128] (JAX defaults), f=128, 64, 32"),
        )
        kernels[2]["float"] = dict(
            path="G1 and G2 forwards with stabilize=True", launches=fg["G1"]["stab_launches"], launches_per_forward=3,
            bf16_launches=fg["G2"]["stab_launches"], max_abs_err=0.0,
            forward_ms=fg["G1"]["stab_ms"], bound_forward_ms=fg["G1"]["bound_ms"], bf16_forward_ms=fg["G2"]["stab_ms"],
            bf16=summed(fg["G2"]["rows5"], over="G2 bfloat16 [512, 256] t32"),
            **summed(fg["G1"]["rows5"], over="G1 float32 [256, 128]"),
        )
        for k, key in ((kernels[-2], "B3"), (kernels[-1], "B4")):
            k["float"] = dict(
                path=f"T: GAT training step over float32 [256, 256] t24 tiles and their transpose (bfloat16: bench.py "
                     f"--train --model gat --tile-dtype bf16), stabilize='bound', {TRAIN_STEPS} steps each",
                launches=fg["T_f32"]["float_counts"][key], bf16_launches=fg["T_bf16"]["float_counts"][key],
                launches_per_step=3, max_abs_err=fg["max_err"][f"{key}_f32"],
                bf16_max_abs_err=fg["max_err"][f"{key}_bf16"], step_ms=gt["times"]["step_ms"],
                bf16_step_ms=fg["T_bf16"]["times"]["step_ms"], losses=tf["losses"], bf16_losses=tb_["losses"],
                bf16=summed(fg["T_bf16"]["rows"][key], over="bfloat16 [256, 256] t24"),
                **summed(gt["rows"][key], over="float32 [256, 256] t24"),
            )
        kernels[1]["repair"] = dict(
            what="C1: one source's as at 120 on the GAT plan, B2/B3/B4 vs plain (stabilize=True and 'bound')",
            max_abs_err=repair["max_err"],
        )
        print(json.dumps({"training": dict(
            times=tt, layers=train["layers"], gcn_losses=train["gcn_losses"], gat_losses=train["gat_losses"],
            bits=dict(times=bt_times, gcn_losses=bits["gcn_losses"], gat_losses=bits["gat_losses"],
                      plan_build_s=bits["build_s"], gat_forward_ms=bits["forward_ms"],
                      gat_stabilized_forward_ms=bits["stab_ms"]),
        )}), flush=True)
    else:
        kernels[0]["training"] = dict(bits=reddit_train)
        print(json.dumps({"training": dict(bits=reddit_train)}), flush=True)
    kernels.append(dict(
        name="sddmm_bcsr", route="cuda", source="gnn_computing_tpu_torch/csrc/sddmm_bcsr.cu",
        replaces="gnn_computing_tpu/ops/bcsr_sddmm.py:100", launches=b6["launches"],
        launches_per_call=b6["parts"], max_abs_err=b6["max_err"],
        **summed(b6["rows"]), path=(
            f"bench.py --model sddmm (hybrid): [256, 128] t24, 1-bit tiles, residual {RESIDUAL_BLOCK}, "
            f"f={SDDMM_F}, split23, f16_split2, bf16 cells; {SDDMM_CALLS} calls"
        ),
        path_ms=b6["path_ms"], edges_per_s=b6["edges_per_s"], residual_ms=b6["residual_ms"],
        build_s=libs["sddmm_bcsr"][1], scale=args.scale,
    ))
    if train is not None:
        kernels[-1]["float"] = dict(
            path=f"S: hybrid_sddmm over G1's float32 plan and the gcn_norm_val float32 [512, 256] t48 plan, "
                 f"f={SDDMM_F}, bf16 cells; {SDDMM_CALLS} calls each",
            launches=fg["S_G1"]["launches"], gcn_norm_launches=fg["S_gcn_norm"]["launches"], launches_per_call=1,
            max_abs_err=fg["max_err"]["B6_f32"], bf16_max_abs_err=fg["max_err"]["B6_bf16"],
            path_ms=fg["S_G1"]["path_ms"], edges_per_s=fg["S_G1"]["edges_per_s"], residual_ms=fg["S_G1"]["residual_ms"],
            gcn_norm_path_ms=fg["S_gcn_norm"]["path_ms"], gcn_norm_edges_per_s=fg["S_gcn_norm"]["edges_per_s"],
            gcn_norm=summed(fg["S_gcn_norm"]["rows"], over="gcn_norm_val float32 [512, 256] t48"),
            bf16=summed(fg["S_bf16"]["rows"], over="G2's bfloat16 [512, 256] t32 plan (a kernel timing, no path)"),
            **summed(fg["S_G1"]["rows"], over="G1 float32 [256, 128]"),
        )
        print(json.dumps({"float_gat": dict(
            G1=dict(forward_ms=fg["G1"]["forward_ms"], stabilized_ms=fg["G1"]["stab_ms"], bound_ms=fg["G1"]["bound_ms"],
                    layer_ms=[r["layer_ms"] for r in fg["G1"]["rows2"]]),
            G2=dict(forward_ms=fg["G2"]["forward_ms"], stabilized_ms=fg["G2"]["stab_ms"], bound_ms=fg["G2"]["bound_ms"],
                    layer_ms=[r["layer_ms"] for r in fg["G2"]["rows2"]]),
            T=dict(f32=fg["T_f32"]["times"], bf16=fg["T_bf16"]["times"]),
            S={k: dict(path_ms=fg[k]["path_ms"], edges_per_s=fg[k]["edges_per_s"], residual_ms=fg[k]["residual_ms"])
               for k in ("S_G1", "S_gcn_norm")},
        )}), flush=True)
    if train is not None:
        kernels += mode_kernel_entries(modes, pr, libs)
        kernels[0]["walk_plans"] = walk["plans"]
        kernels[0]["walk_max_abs_err"] = walk["max_err"]
        kernels[0]["walk_bound_sweep"] = walk["bound_sweep"]
        # phase 38: B3's and B5's lists, checks and times
        dad = next(k for k in kernels if k["name"] == "gat_bwd_dad")
        dad.update(walk="cell", walk_plans=rd["plans"]["B3"], walk_max_abs_err=rd["max_err"],
                   walk_ms={r: v for r, v in rd["times"].items() if r.startswith("B3")})
        kernels[2].update(walk_plans=rd["plans"]["B5"],
                          walk_ms={r: v for r, v in rd["times"].items() if r.startswith("B5")})
        # phase 39: B4's lists, checks and times; B6's streamed pass and the
        # updateval chain with the count plans' lists shared
        dh_das = next(k for k in kernels if k["name"] == "gat_bwd_dh_das")
        dh_das.update(walk="cell", walk_plans=dd["plans"]["B4"], walk_max_abs_err=dd["max_err"]["B4"],
                      walk_ms={r: v for r, v in dd["times"].items() if r.startswith("B4")})
        sd = next(k for k in kernels if k["name"] == "sddmm_bcsr")
        sd.update(design="streamed", pass_plans=dd["plans"]["B6"], pass_max_abs_err=dd["max_err"]["B6"],
                  pass_ms={r: v for r, v in dd["times"].items() if r.startswith("B6")},
                  chain_ms=dd["chain_ms"], chain_builds_first_call=dd["chain_builds_first"])
        print(json.dumps({"modes": dict(
            ablation_ms={label: [{k: v for k, v in r.items() if k.endswith("_ms")} for r in rows]
                         for label, rows in modes["rows"].items()},
            rescued=dict(bcsr_gat.rescued), wide_rescued=modes["wide"], default_off_gate_share=modes["off_share"],
            default_layer_off_gate_share=modes["layer_off"], default_times=modes["times"],
            default_train_losses=modes["train_losses"], default_train_rel_l2=modes["train_rel_l2"],
            probe=dict(times=pr["times"], runs=pr["runs"]),
        )}), flush=True)
    if train is not None:
        # phases 48-50: the reorders' forwards, the CLI's tune and decompose
        rm = reorders["rmat"]
        kernels[0]["reorders"] = dict(
            path=f"GCN forward (fast_layer_opts) over the community graph (hublpa) and the RMAT graph under "
                 f"--reorder {'|'.join(RMAT_REORDERS)}, {forwards} forwards each",
            launches={"community_hublpa": reorders["community"]["launches"], **{k: v["launches"] for k, v in rm.items()}},
            launches_per_forward=3,
            forward_ms={"community_hublpa": reorders["community"]["forward_ms"], **{k: v["forward_ms"] for k, v in rm.items()}},
        )
        kernels[0]["cli_tune"] = dict(path=f"utils.cli tune --syn {CLI_SYN} --iters {CLI_ITERS}",
                                      launches=cli_out["tune"]["launches"])
        kernels[0]["decompose"] = dec["gcn"]
        cg = reorders["community"]["gat"]
        kernels[1]["community"] = dict(path="GAT forward (fast, split2, stabilize=True) over the community graph (hublpa)",
                                       launches=cg["launches"], launches_per_forward=3, forward_ms=cg["forward_ms"])
        kernels[1]["decompose"] = dec["gat"]
        kernels[2]["community"] = dict(path=kernels[1]["community"]["path"], launches=cg["rowmax_launches"],
                                       launches_per_forward=3, forward_ms=cg["forward_ms"])
        print(json.dumps({"reorder": reorders}), flush=True)
        print(json.dumps({"cli": cli_out}), flush=True)
        # phases 51-54: B1 under the all-gather hybrid's rank bodies
        ag, arxiv = par["allgather"], par["arxiv"]

        def b1_rows(rows, **extra):
            return dict(ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                        bound_ms=sum(r["bound_ms"] for r in rows), library_ms=sum(r["library_ms"] for r in rows),
                        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations",
                        rows=rows, **extra)

        kernels[0]["allgather"] = b1_rows(
            ag["rows"], path=f"all-gather hybrid GCN forward, D = {PAR_D} rank bodies (parallel.allgather_tiles, "
                             f"{AG_SCHEDULE}), phase 1's graph, f=128, 64, 32; times summed over one forward's launches",
            launches=ag["launches"], launches_per_forward=ag["launches_per_forward"], max_abs_err=ag["kernel_max_err"],
            forward_ms=ag["forward_ms"],
            transposed=b1_rows(ag["rows_t"], over="the groups' transposes (the step's backward), f=128, 64, 32"),
            arxiv=b1_rows(arxiv["rows"], path=f"the dry run's arxiv-scale forward, D = {ARXIV_D} rank bodies",
                          launches=arxiv["launches"], forward_ms=arxiv["forward_ms"],
                          max_abs_err=arxiv["kernel_max_err"]),
            training=dict(path="the dry run's training step in an NCCL world of one", launches=par["nccl_world"]["launches"],
                          step_ms=par["nccl_world"]["step_ms"]),
        )
        print(json.dumps({"parallel": par}, default=float), flush=True)
        # phases 55-57: B1 and B2 under the figure harness
        for k, kernel in ((0, "B1"), (1, "B2")):
            kernels[k]["figures"] = dict(
                path="the figure harness (gnn_computing_tpu_torch/benchmarks): every figure at --quick (phase 55), "
                     "one real dataset a figure (phase 56)",
                launches={f"{phase}:{run}": r["launches"].get(kernel, 0) for phase in ("quick", "real")
                          for run, r in figs[phase]["runs"].items() if r["launches"].get(kernel, 0)},
            )
        kernels[0]["figures"]["scaling_allgather"] = figs["scaling"]["runs"]["allgather"]["launches"]
        # phase 58: entry() and the port's bench
        kernels[0]["entry"] = dict(path="gnn_computing_tpu_torch.entry.entry(): the flagship GCN forward, int8 "
                                        "[512, 128] t24 split into 1-bit and int8 parts, pack 8", **eb["entry"])
        bench_path = f"python -m gnn_computing_tpu_torch.bench --quick --iters {BENCH_ITERS}"
        for kname, kernel in (("bcsr_spmm", "B1"), ("gat_bcsr", "B2"), ("gat_bwd_dad", "B3"),
                              ("gat_bwd_dh_das", "B4"), ("sddmm_bcsr", "B6")):
            entry_k = next(e for e in kernels if e["name"] == kname)
            entry_k["bench"] = dict(path=bench_path, launches={
                run: r["launches"][kernel] for run, r in eb["bench"].items() if kernel in r["launches"]})
        kernels[0]["bench"]["products_geometry_max_abs_err"] = eb["products_geometry_max_err"]
        # phase 59: the residual kernel at the cells' plans
        r1_rows = [r for rows in r1.values() for r in rows]
        kernels.append(dict(
            name="residual_spmm", route="cuda", source="gnn_computing_tpu_torch/csrc/residual_spmm.cu",
            replaces="none: ops/spmm.py spmm_plain's ATen chunk loop (the JAX package leaves it to XLA)",
            launches=len(r1_rows), launches_per_call=1, max_abs_err=max(r["max_abs_err"] for r in r1_rows),
            path="the hybrid op's residual (ops.spmm.residual_spmm_) at the benchmark cells' residual plans, "
                 "f=128, 64, 32", plans=r1,
            build_s=libs["residual_spmm"][1], scale="products and reddit",
        ))
        print(json.dumps({"bench": eb}, default=float), flush=True)
    print(json.dumps({"sage": sage}), flush=True)
    print(json.dumps({"edgemlp": edgemlp}), flush=True)
    print(json.dumps({"gather": gather}), flush=True)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    if train is not None:
        print(json.dumps({"figures": figs}, default=float), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
