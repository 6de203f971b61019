#!/usr/bin/env python3
"""Drive the PyTorch port of BigCLAM (bigclam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--against DIR=KERNEL[,KERNEL...]]...

Phases, each printed as one JSON line; any failure raises, so the script
exits non-zero:

  card      the card's name and power limit (nvidia-smi), torch and CUDA
  build     nvcc builds every kernel source under bigclam_tpu_torch/csrc/
            for sm_90a, one process per source, all started together,
            and links them into one library; the registers and spill bytes
            of every redesigned kernel (the staged ladder's A, C, #9, #14,
            cand_dots_kb, the staged gradient's B and #8, the member
            lookup, the staged windows of edge_dots_kb and grad_from_x, the
            node pass of cand_from_x.cu) per instantiation, and the ladder
            kernels' launch plans
  against   with --against DIR=KERNELS (any number of them; DIR holds
            another tree's kernel sources, e.g. an earlier commit's
            bigclam_tpu_torch/csrc unpacked into a git-ignored directory,
            with this tree's C signatures): each DIR built the same way
            into a library of its own, and the SASS of the named kernels
            (instruction counts, opcode sequences) set beside this tree's;
            without --against it prints why it was skipped
  odd       each kernel against its plain PyTorch version on a small odd
            case (K=37, isolated nodes), then on a hub graph (planted
            blocks plus nodes of degree 100 and 700, isolated nodes, a
            zero row) at K=37, 1,000 and 1,024
  ring_odd  the ring-phase kernels #8 and #9 against their plain versions
            over every (shard, phase) bucket of the odd graph at dp = 3 on
            a repeated-device mesh (n_pad 405, an empty bucket, a zero
            row), at K=37 and K=1,024, accumulating across the phases;
            then the hub graph at dp = 3, K=37, 1,000 and 1,024; in every
            case #8 under each visit order of the buckets' rows equals #8
            under the identity order bit for bit, and the node pass's
            epilogue (armijo_tail_select) of every shard matches plain
  sparse_odd the member-lookup kernel against its plain version, bit for
            bit, on the odd case's sparse state at M=5 (M < K, truncating)
            and M=37 (not a multiple of 32), before and after a support
            update, plus a random edge batch at M=1, and random member
            rows of 1,100 ids (above the table's k_pad of 1,024: the
            staged search) at M=37 and 64 on the graph's edges
  sparse_mesh_odd every member lookup of two steps of a sparse mesh on an
            uneven dp = 3 mesh of the card (the sweeps read the gathered
            rows, the shard's source ids offset by its first row), bit
            for bit its plain version, on the odd and hub graphs at
            (K, M) = (1000, 37), (1000, 64) and (1100, 1024); then the
            sparse allreduce of the stepped shards' sumF in its sparse
            form, its static-psum form and its overflow fallback, each
            bit for bit the psum helper's sum
  vmem_odd  the candidate edge-terms kernel against its plain version on
            the odd graph at K=37 and K=1,100, in edge chunks of 1,000
            (not a multiple of 32, the last one ragged); then on the hub
            graph at K=37 and 1,000 in chunks of 500 with their runs
            (the degree-700 hub split across two chunks), and with each
            chunk's edges shuffled
  host_odd  the dense conductance backend (A@A in float32 on the card)
            against the native exact triangle counts on the hub graph and
            the parity graph
  kbmesh_odd the K-blocked window kernels with a destination tensor
            (F_dst) against their plain versions: on the odd graph at K=37
            and the hub graph at K=37, 1,000 and 1,100 (2 windows of 576),
            over every shard of a dp = 3 all-gather mesh (F_dst the
            gathered F) and every (shard, phase) bucket of the dp = 3 ring
            (F_dst the rotating shard, the empty bucket included): the dots
            (directed), the gradient with and without the fold and added
            into random accumulators (the ring's accumulate mode, its LLH
            too), the candidate dots; edge_dots_kb's directed mode equal to
            its pair mode bit for bit on each whole graph
  quality_odd the quality pipeline's component pass (ops.components) on
            the card against the port's CPU pass (labels, sizes, internal
            edges bit for bit) and the scipy oracle (labels = its
            components' min ids) on the odd and hub graphs with 24 random
            thresholded columns (an empty one, a singleton, every node,
            the isolated nodes alone), and again at two columns a batch
            (a patched EDGE_ELEM_BUDGET), bit for bit; the device kick
            (DeviceNoise, twice the same draw), the scatter edits and
            clear_col on the dense layout (K=37, k_pad 64) and on a dp = 3
            repeated-device mesh of the hub graph (n_pad 807): every
            padding row and column stays exactly zero
  graph     AGM planted N=300,000, K=1,000, p_in=0.1, numpy rng seed 1,
            written as a SNAP edge list to a temporary directory
  main      the port's `cli fit` entry on the CUDA device at full width on
            that file (`--graph`, text ingest included), conductance init,
            5 iterations, `--out communities.txt`; path `csr_fused`,
            launches counted from 0 around the fit; the native host
            library loaded; the graph, seeding and extract stage seconds
            beside those before the native library and the array writer;
            the file's bytes, every line, equal to the plain writer's for
            the same F and graph (membership_mask's pairs sorted and
            formatted in bulk on the card, its first lines
            save_communities' own)
  host_full the host stages at full, each against its plain version and
            timed: the native parse against parse_bytes (equal arrays),
            then graph_from_edges; the native exact triangle counts, and
            the seeding stage split into conductance, rank_seeds and
            init_F; the capped estimator at cap
            16 natively, in numpy and as sampled_device on the card (rtol
            1e-9 and 2e-5 to native, identical rank_seeds), and
            sampled_device at cap 64 (>= the max degree) equal to the
            exact counts; the device extraction of main's F on the card
            against the host one (equal ids, offsets and members), with
            its peak device memory
  mesh_init the file ingested as `cli fit` reads it and its conductance F0
  store_full (as listed below, run here since PR 22) the full graph's
            4-shard cache: from here on the full-size `cli` runs read it
            (`--graph <cache>`: the same graph and, from its baked scores,
            main's F0) in place of the text, whose parse main and
            host_full time (each parse took 3-4.6 s, a dozen of them)
  split     the same graph and init with --csr-fused off (path `csr`),
            2 steps, launches counted from 0 around the fit
  full      each kernel against its plain version at the main path's
            shapes (the main fit's final F), and both timed with CUDA
            events: the median of 10 runs, taken as two rounds of 5
            after a warm-up each, in the order plain, kernel, kernel,
            plain; the graph's ladder tiles by the row groups they run;
            kernel C and its float32 plain version against float64 on the
            conductance F0 (errors reported: the tails cancel there)
  sparse_main `cli fit --representation sparse --sparse-m 64` on the same
            file, conductance init, 5 iterations, no --out; path
            `sparse_merge_pallas`, the launches counted from 0 around the
            fit (member lookups: the grad sweep's chunks x steps; one
            candidate sweep a step); the LLH rises; peak device memory and
            the state's bytes against a dense F's
  sparse_full the member-lookup kernel against its plain version over
            every edge of sparse_main's final state (bit for bit), both
            timed as `full` times kernels; the candidate-sweep kernel
            against the plain sweep on the step's inputs (float32 band),
            both timed; one step timed split into the member kernel, the
            candidate kernel, the rest of the grad/candidate passes, the
            Armijo update, the support update and the two sumF scatters,
            and traced once with torch.profiler (device busy time, top
            ops and kernels)
  cand_sweep_yt the candidate-sweep kernel at the benchmark's sparse cell's
            shapes (N 1,134,890, 2E 5,975,248, K 8,385, M 64, 16 steps;
            random member rows and CSR-order edges) against the plain
            sweep, both timed beside the sweep's bound
  sparse_mesh_full `cli fit --mesh 4,1 --representation sparse
            --sparse-m 64` on the same file (the four positions share the
            card), 5 iterations: the path and its exchange mode, the
            member-lookup launches against the schedule, the LLH within
            1e-4 of sparse_main's, sec_per_iter beside it, peak device
            memory against the fit's model (check_peak), the comms bytes
            counted in one step against the model; one step timed whole
            and split (gathers, support, allreduces, grad_sweep,
            cand_sweep, armijo)
  sparse_mesh_local com-youtube's shape: planted blocks of 135 nodes at
            N=1,134,890, K=8,385, p_in=0.04, default_rng(19), on
            --mesh 8,1 of the card at M=64, the community-local init
            (weight SPARSE_LOCAL_W in the node's block) through the
            hooks init_state calls after from_dense; 6 steps: the path
            ends in `_spall`, fewer than K/2 ids exchanged a step, no
            fallback, member launches against the schedule, the LLH
            rises; the cap, counted against modeled comms bytes,
            sec_per_iter, peak device memory beside the dense F's
  vmem_main `cli fit --csr-kernels off` on the same file, conductance
            init, 5 iterations, no --out; path `pallas_vmem`, the
            candidate edge-terms launches counted from 0 around the fit
            (one per edge chunk and step) and the node pass's epilogue
            (one a step); the LLH rises and stays within 1e-4 of main's
            `csr_fused` history; peak device memory
  vmem_full the candidate edge-terms kernel against its plain version
            over every edge chunk of vmem_main's final F (with the runs the
            model caches), both timed as
            `full` times kernels; the epilogue kernel against its plain
            version on the step's inputs, timed beside torch
            `armijo_update`; one `pallas_vmem` step timed split into the
            torch grad pass, the kernel, the `index_add_` sums and the
            Armijo update (the epilogue kernel, the column sums, the
            histogram), and traced once with torch.profiler; one `xla`
            step (use_pallas=False) on the same state for comparison
  sweep_main `cli sweep --min-com 500 --max-com 1000 --div-com 2
            --max-iters 5` on the same file: the grid, at least 2 trained
            Ks, finite LLHs, the seconds per K; path `csr_fused`
  parity    planted N=2,400, K=100: 5 steps on the card (f32 kernels)
            against the port's CPU `xla` path in float64
  sparse_parity the same graph on the sparse path at M=16 and M=100: 5
            steps on the card against the port's CPU float64 sparse path,
            and at M=100 = K against the card's dense `csr_fused` path
  sparse_mesh_parity the same graph on a (4, 1) sparse mesh at M=16
            against the CPU float64 sharded fit (LLH within 1e-4); a cap
            of 8 that overflows every step (comm_dense 1, each allreduce
            bit for bit the psum of its inputs) beside the psum build;
            a checkpoint at 2 restored bit for bit and resumed, beside
            two uninterrupted fits
  vmem_parity the same graph on `pallas_vmem`: 5 steps on the card against
            the port's CPU `xla` path in float64
  ring_main `cli fit --mesh 1,1 --schedule ring` on the same file,
            conductance init, 5 iterations, no --out; path
            `csr_ring_fused`, one launch of each ring kernel and of the
            epilogue per step, counted from 0 around the fit; the LLH rises
            and stays within 1e-4 of main's
  ring_dp4  RingBigClamModel on 4 shards of one card (balanced), 5 steps
            of `csr_ring_fused` from that F0 (16 launches of each ring
            kernel and 4 of the epilogue a step), 2 of `csr_ring`, LLHs
            within 1e-4 of main's; one step timed whole and split into
            rotation 1, the fold, rotation 2, the epilogue of every shard
            (with the column sums and histograms) and the psums, beside the
            torch tails it replaced, and traced; peak device memory
  ring_full #8 and #9 against their plain versions over every bucket of
            that layout on the final F, each timed per sweep of 16
            buckets as `full` times kernels, with their bound; #8 under
            each visit order (identity, pre-balance node order, first
            neighbour), bit-equal to the identity order and timed per
            sweep; both sweeps timed again on the unbalanced layout of the
            same F, #8 there under each visit order too; the epilogue of
            every shard against plain, timed over the 4 shards beside torch
            `armijo_update`
  allgather_main `cli fit --mesh 1,1` (path `csr_fused`, LLH within 1e-4
            of main's), then ShardedBigClamModel on 4 shards of one card:
            5 steps of `csr_fused`, 2 of `csr`, with launches and LLH
  ring_multi ring_dp4 on min(4, count) real cards, where the hops are
            copies, with the serial rotation equal to the overlapped one
            bit for bit; with one card it prints why it was skipped
  tp_full   the all-gather and ring trainers at full on a (2, 2) mesh of
            the one card from mesh_init's F0 (k_pad 1,024, K_loc 512: the
            TP split with its psums over k and the tails in torch), 5
            steps: launches, the LLH within 1e-4 of main's, seconds a step
            beside main's, peak device memory measured and modeled (the
            model within 25% and not below the peak), the step split
  store_full `cli ingest --shards 4` of the full edge list (seed scores
            and closure lists baked): seconds, raw edges/s, the stage
            split (scan, scatter, dedup, shards, seed_bake, closure_bake),
            the peak RSS delta and the cache bytes; the cache's graph equal
            to build_graph's and its baked-score F0 equal to main's; then
            `cli fit --graph <cache>` at K=1,000, 5 iterations: the baked
            scores used, `csr_fused` with main's launches, the LLH history
            bit for bit main's, its graph and seeding stages beside main's;
            then `--cache-dir` twice on the parity graph's text (N=2,400,
            K=100, 1 iteration each; at full until PR 22, whose compile
            seed-baked the graph a second time, 33 s): the first compiles,
            the second reloads, both on the text-fed fit's history
  store_native_dp4 `cli ingest --balance --shards 4 --no-seed-bake
            --no-closure-bake`, then `cli fit --mesh
            4,1 --store-native` on one card repeated four times: the
            unbalanced cache under allgather (`csr_fused`, 4 launches a
            step) and ring (`csr_ring_fused`), the balanced one under ring;
            each held against the in-memory trainer on the same layout and
            F0 bit for bit (where they differ, a second in-memory run: if
            the two in-memory runs differ too, within 1e-6), each position's files_read its own shard's blobs,
            sec_per_iter beside allgather_main's and ring_dp4's dp = 4
            steps, the host memory of the store-native build beside the
            in-memory one (RSS growth and tracemalloc's allocation peak)
  store_heal corrupt_shard on shard 1 through the fault plan: the
            cache-fed fit quarantines it (one `quarantine` event),
            rebuilds it from the text and trains to main's history bit for
            bit; with --no-self-heal `cli.main` raises ShardCorruption
  store_delta a delta of 1% new edges among the first half of the nodes
            (default_rng(15)) by `cli ingest --delta` on a copy of
            store_full's 4-shard cache: touched shards and share, seconds, the
            re-baked phi; the cache's graph equal to a fresh in-memory
            ingest of text + delta (build_graph), the re-baked phi equal to
            its exact conductance, the untouched shards' blobs unchanged to
            the byte; one cache-fed fit step on the card
  quality_full (after store_delta) fit_quality_device at full from
            mesh_init's F0 on csr_fused, QUALITY_FULL's schedule (6
            cycles, 1 repair round, 100 steps a fit): the stage seconds and
            transfer counts (one upload, at most rounds + 1 fetches),
            fused_superstep launched once for every step run, omp_lo
            float32(1 - max_p_q) on every launch and the parity cfg back
            after, every component pass on the card (none through scipy),
            steps and seconds a step beside main's, peak device memory,
            the zero rows and the LLH before (main's 5-step fit) and after
            (also under the parity clip); then the component pass on the
            card beside scipy over the final F's first 128 columns
            (QUALITY_COMPONENT_COLS), labels equal
  quality_tp (after quality_full) `cli fit --mesh 2,2 --quality
            --device-annealing` on the full file, four positions on one
            card, cut to 2 cycles of at most 20 steps and one repair
            round: the window kernels and cand_nbr_from_x launched as
            many times as the K-sharded steps run imply, steps and seconds
            a step beside quality_full's and tp_full's, stage seconds and
            transfer counts, the peak beside the fit's memory model plus
            two F-sized tensors (check_peak), the zero rows and the LLH
            before and after; then the parity graph on (2, 2) (K = 100 in
            two column blocks of 64): cycle 0 on the card against CPU
            float64 on a (2, 2) mesh fed the same kicks, within 1e-4
  serve_publish `cli fit --graph <store_full's 4-shard cache> --k 1000
            --max-iters 5 --publish-dir snaps` on the card: the published
            F equal to --save-f's bit for bit, fused_superstep once a
            step; then `--representation sparse --sparse-m 64
            --publish-dir snaps_sparse` and its final member lists
            published as a sparse generation: seconds, archive bytes,
            generations
  serve_full `cli serve --snapshots snaps --graph <cache>` on the card, a
            seeded mix (default_rng(16)) of 4,096 queries (dense: its
            first 1,024 once; sparse: all x 3): 45% communities_of, 45% members_of (Zipf 1.1
            over communities by mass), 10% suggest_for (half existing
            nodes, half new ones with 20-60 neighbour ids); dense, then
            sparse: p50/p99/QPS, cache hit rate, fold-in batches and
            iterations, no error, 64
            suggest answers of an in-process server against the CPU
            float64 FoldInEngine (LLH at 1e-4, sets equal but at
            near-ties), fold-in ms per batch at B=8 and 64, the dense
            snapshot's zero rows and index pairs; on the sparse snapshot
            a hot swap mid-stream (a second publish while the in-process
            server watches every 0.1 s: one swap, nothing dropped) after
            which an existing node's suggest recovers its row (its
            converged fold-in row, published as its member list) within
            1e-3
  refit_full 1,000 new edges among the first shard's nodes
            (default_rng(17)) through `cli ingest --delta` on a copy of
            the cache, then `cli refit --refit-rounds 3` on the card:
            touched, refit nodes, rounds, fold-in iterations, seconds,
            refit_cost_ratio; rows outside touched + halo bit for bit the
            previous generation, the restricted objective never falling
            unless escalated, the next generation, and the first batch
            against the CPU float64 fold-in
  fleet_full (after refit_full) `cli fit --representation sparse
            --sparse-m 64 --publish-shards 2` on store_full's cache (a fleet
            generation of serve_publish's sparse fit), `cli fleet up
            --shards 2 --replicas 1 --device cuda` with a members file,
            serve_full's mix's first 1,024 queries through `cli route
            --members`:
            reads equal single-process `cli serve` on the un-sharded
            archive of the same member lists bit for bit, suggests within
            1e-4 of CPU float64, no serve error, every replica on the
            card; one replica killed and restarted by the supervisor, a
            second round (the first 512 queries) the same; `fleet
            drain`, `fleet down`; p50/p99/QPS beside serve_full's, the
            restart seconds
  follow_parity at parity size `cli fit --follow --follow-max 2` on the
            card in a thread while an in-process MembershipServer (watch
            0.1 s) serves a stream; two deltas dropped in turn: 2
            generations, 2 swaps, no serve error; the LLH history and
            each generation's LLH within 1e-4 of the same loop on the
            CPU in float64
  quality_parity (after follow_parity) tests/test_quality.py's graph
            (planted N=2,400, 12 blocks, p_in=0.15, rng 7): the faithful
            `cli fit`, `cli fit --quality --restart-cycles 8` and the same
            with --device-annealing on the card, csr_fused with one launch
            a step (`--metrics` records); both quality fits at F1 >= 0.8
            and 0.2 above the faithful one against the planted truth, the
            kept LLH never falling; cycle 0 (restart_cycles 1, no repair)
            at the auto clip and at a pinned 1 - 1e-6 against the port's
            CPU float64 run from the same kicked F (LLH within 1e-5), the
            kernels' omp_lo float32(1 - max_p_q) during and the parity
            value after; the device schedule run twice, bit for bit or not
  gexf      (after quality_parity) `cli fit --export-gexf` on the parity
            graph on the card (csr_fused, a launch a step) and in CPU
            float64: the file parses, its nodes and edges are the graph's,
            its community attributes the CPU run's but at near-ties
  sweep_parity `cli sweep` over the grid (50, 100, 3), 5 iterations per K,
            on the card against `--device cpu --dtype float64`: the same
            grid and chosen K (unless a stop ratio lies within 1e-4 of
            ksweep_tol), each K's LLH within 1e-4
  mesh_parity the parity graph: the ring and the all-gather schedules at
            dp = 4 on the card against the port's CPU float64 `xla` at
            dp = 4 and on one device, 5 steps, LLH within 1e-4; then at
            csr_k_block=32 the meshes (4, 1) and (2, 2) on both schedules
            against CPU float64 `xla` on the same mesh, a (2, 2) fit
            checkpointed at 2 and resumed bit for bit, and `sweep --mesh
            2,2 --csr-k-block 32` over (50, 100, 3) picking CPU float64's K
  resilience_full (after `full`) `cli fit` at full on `csr_fused`, 6
            iterations, --checkpoint-every 2, --telemetry-dir,
            --health-every 2, --metrics (a): kernel A launched once a step,
            checkpoints at 2, 4 and 6 with their save seconds and bytes,
            health samples at 0, 2, 4, 6, every event valid against the
            schema, sec_per_iter beside main's; the same fit in a
            subprocess (started beside (a), so (a)'s seconds share the
            host with it) killed (SIGKILL, BIGCLAM_FAULTS) at fit.step 4 and
            resumed in-process with --resume auto (b): its LLH history
            equal to (a)'s bit for bit (band 1e-6), 3 launches, the resume
            lineage; a NaN injected into F at 3 on the model's fit (c):
            one `rollback` event (iter 3, resume 0, step_scale 0.1, a
            non-finite LLH), kernel A launched once for every step run,
            the replay on the scaled ladder included, a finite history;
            health every 10 against 0 (d), fits of 11 steps in the order
            0, 10, 10, 0, the trajectory unchanged, the health pack and
            the rollback snapshot's refresh timed with CUDA events; peak
            device memory of a 2-step fit with and without the snapshot
  resilience_odd (after mesh_parity) the parity graph on csr_fused, csr,
            csr_fused_kb and csr_grouped_kb (csr_k_block 32), pallas_vmem,
            sparse_merge_pallas (M=16) and csr_ring_fused (dp = 4): a NaN
            in F at 2 gives a non-finite LLH, one rollback and a finite
            history, each path's kernels launched; A, B, C, the K-blocked
            kernels with the node pass (K=1,100) and the epilogue against
            their plain versions on the ladder scaled by 0.1 (odd graph);
            a resume from the checkpoint at 4 against the uninterrupted
            fit on sparse_merge_pallas (band 1e-5: index_add_'s atomic
            order differs from run to run, and two uninterrupted fits are
            set beside it) and csr_ring_fused (band 1e-6)
  obs_memory (after resilience_full) each path's memory model
            (obs.memory) against the card: csr_fused with and without the
            rollback snapshot, sparse_merge_pallas (M=64), pallas_vmem, the
            ring at --mesh 1,1 and at dp = 4 on the one card, each built,
            uploaded and fitted 3 steps from the conductance F0 with the
            bytes allocated before the model subtracted from torch.cuda's
            peak; the addressable reconcile (state + graph storage bytes)
            exact on the uploaded and the final state; modeled device bytes
            beside the measured peak (csr_fused within 10%); the column
            sum's temporary the model leaves out; `cli preflight` of the
            graph beside the csr_fused peak; the card's total memory equal
            to the preflight table's row
  obs_profile `cli profile --steps 3` on the file: the captured device
            kernels by time name kernel A (`fused_superstep_kernel`) with
            device time > 0 and no GEMM, gather or scatter kernel; the
            unprofiled step (10 steps, the observability layer off)
            beside PR 13's 0.0370 s
  obs_ledger (after resilience_odd) `cli fit --telemetry-dir
            --perf-ledger` twice on the parity graph (20 iterations) into
            a temporary ledger: `perf diff` names the first as the
            second's baseline and exits 0; a third fit with --alpha 0.1
            has no baseline (exit 1); the port's `cli report --json` of
            the first run

and the large-K (K-blocked) paths, on the repo's `xl_k` configuration
(bench.py: AGM planted N=60,000, K=3,000, p_in=0.5, numpy rng seed 3;
k_pad 3,072 in 3 blocks of 1,024 columns):

  kb_graph  that graph, written as a SNAP edge list
  host_xlk  the numpy triangle loop against the native pass on it
  kb_main   `cli fit --graph` at K=3,000, conductance init, 5 iterations,
            no --out; path `csr_fused_kb`, per step 3 launches of each
            window kernel and 1 of the node pass (cand_select_from_x),
            counted from 0 around the fit; the LLH rises
  kb_split  the same with --csr-fused off (path `csr_grouped_kb`), 2
            steps; its LLHs equal kb_main's first two within 1e-4
  kb_full   each K-blocked kernel against its plain version from
            kb_main's F (x, x symmetric bit for bit through the reverse-edge
            index, grad with and without the fold, llh_nbr, xc, cand_nbr,
            and the node pass's node_llh, mask and F_new), both timed per
            full step as `full` times them, the node pass also beside the
            torch epilogue it replaced (the neighbour-only entry, the node
            tail and `armijo_update`), and the whole step timed split into
            the edge kernels, the node pass and the torch rest (column
            sums, histogram, LLH); the dots and the gradient again, vs
            plain and timed, on the graph relabelled by a seeded
            permutation (F's rows permuted to match: no id locality);
            `sampled_addmm` beside the dots (library_ms) and a sparse
            product of the 1/omp coefficients with F beside the gradient
            (its aggregation alone); the graph's ladder tiles by the row
            groups they run
  kb_odd    K=1,100 (2 blocks of 576) on the odd graph and on the hub
            graph (the degree-700 hub crosses 22 ladder tiles in each
            window), and K=37 in windows of kc=3 (csr_k_block) on the odd
            graph (windows off 16 bytes: the 4-byte copies), kernels vs
            plain (the node pass included), the dots symmetric bit for bit
  kb_parity planted N=2,400, K=100 with csr_k_block=32 (4 blocks) on
            both K-blocked paths on the card against the CPU float64
            `xla` path
  kbmesh_xlk (after resilience_kb) `cli fit` at K=3,000 on the meshes of
            one card: --mesh 4,1 (`csr_fused_kb`, 3 windows of 1,024),
            --mesh 4,1 --schedule ring (`csr_ring_fused_kb`), --mesh 2,2 on
            both schedules (K_loc 1,536 in 2 windows of 768), 5 iterations
            each, and the split twins `csr_grouped_kb` and `csr_ring_kb`
            (--csr-fused off) 2 steps: each run's launches equal to what its
            schedule implies, its LLH within 1e-4 of kb_main's one-card
            history from the same F0, sec_per_iter, peak device memory
            measured beside the fit's modeled bytes (within 25%, and not
            below the peak at tp > 1); each fused run's step from kb_main's
            F timed whole and split (gather, dots, k_psum, consume, tails,
            the ring's hops, finish: parts that do not overlap);
            edge_dots_kb's directed mode
            against its pair mode on the whole graph, bit for bit, both
            timed per step of 3 windows
  store_kb  `cli ingest --shards 4` of the xl_k file, then `cli fit
            --store-native --mesh 4,1` at K=3,000 (1 iteration): the fitted
            F and the LLH history bit for bit the in-memory --mesh 4,1
            fit's on the same cache
  resilience_kb (after kb_full) a NaN at 2 on csr_fused_kb from kb_main's
            F: one rollback, then every launch of the replay on the scaled
            ladder counted (3 window kernels and the node pass a step)
  obs_memory, obs_profile (after resilience_kb) as at full, on
            csr_fused_kb from kb_main's F (gate within 10%); the profile
            names `cand_dots_kernel`, `edge_dots_kernel`,
            `grad_from_x_kernel` and the node pass (`node_pass_kernel`),
            the unprofiled step beside PR 13's 7.84 ms

The 2D edge-block partition (parallel/twod.py), every position of a grid
on the one card:

  twod_odd  (after kbmesh_odd) the odd graph at K=37 on (2, 2) and (3, 1)
            grids, the hub graph at K=1,000 on (2, 2) and K=1,100 on both:
            each kernel the 2D step launches against its plain version on
            the closure-table inputs (kernel A with the closure table as
            its destination rows at C = 1; #8 and #9 over the row group's
            rows from random accumulators, F_rot the closure table, and the
            epilogue on the own block's inputs of a plain step at C > 1;
            the K-blocked windows through compare_kb_dst, then the node
            pass (C = 1) or the neighbour sums (C > 1)); at C > 1
            closure_grad_allreduce on #8's partials bit for bit the dense
            psum in every row a position touched or owns; a
            closure_grad_cap = 1 build on (2, 2) falling back on each of 4
            steps, bit for bit the dense build
  twod_full (after tp_full) `cli fit --mesh 4,1` (the 1D all-gather) and
            `--partition 2d` at --replica-cols 1 and 2 on the full file, 5
            steps each: C = 1 takes csr_fused_2d on kernel A with the
            all-gather's history bit for bit, C = 2 csr_fused_2d on #8/#9
            with the closure exchange, within 1e-4 of main's; per run the
            launches the schedule implies, sec_per_iter beside the
            all-gather's, the collective bytes counted a step equal to
            twod_step_model's, the peak beside twod_memory_model
            (check_peak), the exchanged ids and fallback flag
  twod_store (after store_native_dp4) store_full's 4-shard cache through
            StoreTwoDShardedBigClamModel on (4, 1) and (2, 2): the baked
            closure lists, and 2 steps from main's F0 bit for bit the
            in-memory 2D trainer's
  twod_parity (after mesh_parity) the parity graph on a (2, 2) grid:
            csr_fused_2d on the card against the CPU float64 xla_2d on
            (2, 2) and one device (LLH within 1e-4), a checkpoint at 2
            resumed bit for bit, `sweep --mesh 4,1 --partition 2d
            --replica-cols 2` against the CPU float64 sweep (the same K)
  twod_xlk  (after kbmesh_xlk) `cli fit --mesh 4,1 --partition 2d` at
            K=3,000 with --replica-cols 1 and 2 (csr_fused_2d_kb, 3 windows
            of 1,024), twod_full's numbers against kb_main's history

Multi-process meshes (parallel/multihost.py), after kbmesh_xlk; rank 0
of each run in this process (its launch counters zeroed around it), the
others subprocesses started during the run before (they wait in the
rendezvous), every rank from an empty directory of its own:

  dist      nccl1: one NCCL rank (WORLD_SIZE=1) of `cli fit --distributed
            --mesh 4,1 --store-native --schedule ring` on store_full's
            cache, store_native_dp4's 4 iterations: `csr_ring_fused`, #8,
            #9 and the epilogue launched the schedule's count, the LLH
            history store_native_dp4's ring run's bit for bit; gloo2_full:
            two ranks sharing the card over gloo (BIGCLAM_DIST_BACKEND=
            gloo), the same cache on the all-gather schedule with --out,
            --checkpoint-dir --checkpoint-every 2 and --telemetry-dir:
            store_native_dp4's all-gather history bit for bit on both
            ranks, each rank's files_read its two shards, rank 0 alone
            writing the communities file (held every byte by hold_writer
            against the fetched F), the checkpoints and the events
            (`processes: 2`), kernel A launched 2 x steps on rank 0;
            gloo2_xlk: two ranks at --mesh 2,2 on the xl_k file in memory
            (`csr_fused_kb`, a node row of column blocks a rank):
            kbmesh_xlk's (2, 2) all-gather history bit for bit; both gloo
            runs 2 iterations (DIST_GLOO_ITERS), held against the same
            steps of their single-controller runs, rows 10-12 and 7 launched rank 0's share. Per run and rank
            sec_per_iter, stage seconds and the bytes moved across ranks

Then one `side_by_side` line (with --against: each named kernel on the
inputs of its timing phase (`full`, `sparse_full`, `vmem_full`,
`ring_full`, `kb_full`; in `kb_full` the gradient also without the fold,
and the dots and the gradient also on the shuffled ids)
under this tree's library and the other one, outputs compared bit for bit
and both timed as `full` times a kernel and its plain version), one
`kernels` line (per kernel: launches on its path, error against the plain
version, kernel / plain time, the card's lower bound for the same work;
fused_superstep's row adds its launches in quality_full, in
quality_parity's three fits and in gexf, member_lookup's in
sparse_mesh_full, sparse_mesh_local and fleet_full's fit, the K-blocked
rows theirs in quality_tp and its parity run, the rows a 2D step
launches theirs in twod_full and twod_xlk; twod_odd's comparisons count
toward their errors)
and, last, {"ok": true, "device": {...}}. The ring, mesh and store
phases run after sweep_main, in the order listed; mesh_parity after
sweep_parity.

Tolerances: F_new, grad, node_llh, the candidate LLH, the candidate edge
terms, the K-blocked kernels' x, grad, llh_nbr, xc and cand_nbr and the
node pass's node_llh and F_new at rtol = atol = 3e-5
(relative errors are reported as |got - want| / (|want| + 3e-5)) (the
float32 band the JAX package holds its fused, split and XLA paths to); the
0/1 acceptance mask must be equal except where
|cand - threshold| <= 1e-5 * max(1, |threshold|) (a near-tie that
another summation order may flip); F_new is compared on every row with the
plain selection and projection applied to the kernel's own mask. LLH
histories agree at rtol 1e-4. The member lookup is exact (a hit copies
the stored weight, a miss gives 0), so it must equal its plain version
bit for bit (torch.equal).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM data sheet peaks: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
RTOL = ATOL = 3e-5
TIE = 1e-5
LLH_RTOL = 1e-4

DEVICE = "cuda"
CARD = {}                 # the card line of phase_card, stamped on later phases
FULL = dict(n=300_000, k=1000, p_in=0.1, seed=1)
ODD = dict(n=400, k=37, blocks=20, p_in=0.3, isolated=5, seed=3)
HUB = dict(n=800, blocks=40, p_in=0.3, degrees=(100, 700), isolated=5, seed=5)
HUB_K = (37, 1000, 1024)
PARITY = dict(n=2400, k=100, p_in=0.3, seed=0)
XLK = dict(n=60_000, k=3000, p_in=0.5, seed=3)
KB_ODD_K = 1100
KB_ODD_KC = 3             # csr_k_block windows that start off 16 bytes
KB_PARITY_KC = 32
KBMESH_DP = 3
KBMESH_HUB_K = (37, 1000, 1100)
SPARSE_M = 64
SPARSE_ODD_M = (5, 37)
SPARSE_SEARCH_K = 1100    # k_pad above the member lookup's table (1,024)
SPARSE_PARITY_M = (16, 100)
VMEM_ODD_K = (37, 1100)
VMEM_ODD_CHUNK = 1000
VMEM_HUB_K = (37, 1000)
VMEM_HUB_CHUNK = 500      # splits the degree-700 hub across two chunks
# div 2 since PR 22 (was 4: six Ks of ~2.4 s), after a proof ran past the
# 1,200 s limit
SWEEP_MAIN = dict(min_com=500, max_com=1000, div_com=2,
                  kset=[500, 707, 999, 1000])
SWEEP_PARITY = dict(min_com=50, max_com=100, div_com=3)
HOST_CAP = 16             # the capped estimator's cap at full (binds: max degree 58)
HOST_EXACT_CAP = 64       # >= full's max degree: the estimate is the exact count
HOST_RTOL_NATIVE = 1e-9   # native vs numpy estimates (summation order only)
HOST_RTOL_DEVICE = 2e-5   # the float32 device estimate vs the host one
# `cli fit` stage seconds at full before the native host library and the
# array writer (this script on the code before them, NVIDIA H100 80GB
# HBM3, 700 W)
BEFORE_STAGE_SECONDS = {"graph": 5.31, "seeding": 9.53, "extract": 39.2}

KERNELS = {
    "fused_superstep": dict(
        source="bigclam_tpu_torch/csrc/fused_superstep.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:287",
        tpu_kernel="fused_superstep_csr",
        redesigned="the staged candidate ladder (edge_common.cuh ladder_range)",
    ),
    "grad_llh_csr": dict(
        source="bigclam_tpu_torch/csrc/grad_llh.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:333",
        tpu_kernel="grad_llh_csr",
        redesigned="neighbour rows staged by cp.async (edge_common.cuh staged_grad_pass)",
    ),
    "candidates_csr": dict(
        source="bigclam_tpu_torch/csrc/candidates.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:409",
        tpu_kernel="candidates_csr",
        redesigned="kernel A's tails and staged candidate ladder (ladder_pass)",
    ),
    # the K-blocked kernels: one CUDA kernel for each pair of TPU twins
    "edge_dots_kb": dict(
        source="bigclam_tpu_torch/csrc/edge_dots_kb.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:573",
        tpu_kernel="edge_dots_fused",
        also_replaces="bigclam_tpu/ops/pallas_csr.py:465 (edge_dots_csr)",
        redesigned=("each undirected pair once through the reverse-edge index, "
                    "neighbour windows staged by cp.async (edge_common.cuh window_walk)"),
    ),
    "grad_from_x": dict(
        source="bigclam_tpu_torch/csrc/grad_from_x.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:668",
        tpu_kernel="grad_nbr_from_x_fused",
        also_replaces="bigclam_tpu/ops/pallas_csr.py:523 (grad_nbr_from_x_csr)",
        redesigned=("neighbour windows staged by cp.async (edge_common.cuh "
                    "window_walk), written in place into the step's gradient"),
    ),
    "cand_dots_kb": dict(
        source="bigclam_tpu_torch/csrc/cand_dots_kb.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:760",
        tpu_kernel="cand_dots_fused",
        also_replaces="bigclam_tpu/ops/pallas_csr.py:585 (cand_dots_csr)",
        redesigned="the staged candidate ladder over a column window, with row groups",
    ),
    # row 7's source: the node pass that ends the K-blocked step (its
    # launches are `cand_select_from_x`'s) and the neighbour-only entry
    "cand_from_x": dict(
        source="bigclam_tpu_torch/csrc/cand_from_x.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:645",
        tpu_kernel="cand_nbr_from_x_csr",
        entry="bigclam_cand_select_from_x",
        also_computes="bigclam_tpu/ops/linesearch.py:141 (armijo_update, XLA)",
        redesigned=("the node pass that ends the step: a warp (K <= 1,024) or a block "
                    "a node, F_u and g_u in registers by float4, the neighbour sums "
                    "in sectors, tails, test and selection, F_new written once"),
    ),
    # the node pass's epilogue from given neighbour sums (the ring and
    # pallas_vmem steps): the same kernel template
    "armijo_tail_select": dict(
        source="bigclam_tpu_torch/csrc/cand_from_x.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:645",
        tpu_kernel="cand_nbr_from_x_csr",
        entry="bigclam_armijo_select",
        also_computes="bigclam_tpu/ops/linesearch.py:141 (armijo_update, XLA)",
        redesigned="the node pass's epilogue (node_pass_kernel<Nbr::kGiven>)",
    ),
    "member_lookup": dict(
        source="bigclam_tpu_torch/csrc/member_lookup.cu",
        replaces="bigclam_tpu/ops/sparse_members.py:234",
        tpu_kernel="member_lookup_pallas",
        redesigned=("spans of 32 edges a warp, u's ids in registers, v's members in a "
                    "tagged id table (k_pad <= 1,024), else staged by cp.async and searched"),
    ),
    # no TPU counterpart: the JAX package leaves the sparse candidate
    # sweep to XLA's fusion after member_lookup_pallas
    "cand_sweep": dict(
        source="bigclam_tpu_torch/csrc/cand_sweep.cu",
        replaces=None,
        tpu_kernel=None,
        also_computes="bigclam_tpu/ops/sparse_members.py:380 (sparse_candidates, XLA)",
        redesigned=("member_lookup's span layout, the lookup kept in registers, "
                    "nf_s per source, 16 dots, one transposing reduction, edge "
                    "terms and per-source sums added by atomics"),
    ),
    "candidate_edge_terms": dict(
        source="bigclam_tpu_torch/csrc/candidate_edge_terms.cu",
        replaces="bigclam_tpu/ops/pallas_kernels.py:71",
        tpu_kernel="candidate_edge_terms",
        redesigned="the staged candidate ladder over runs of one source's edges",
    ),
    "ring_grad_phase": dict(
        source="bigclam_tpu_torch/csrc/ring_grad_phase.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:413",
        tpu_kernel="_grad_blocks_fused",
        redesigned="a visit order per bucket, neighbour rows staged by cp.async",
    ),
    "ring_cand_phase": dict(
        source="bigclam_tpu_torch/csrc/ring_cand_phase.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:503",
        tpu_kernel="_cand_blocks_fused",
        redesigned="the staged candidate ladder with row groups",
    ),
}
RING = ("ring_grad_phase", "ring_cand_phase")
# the staged candidate ladder (csrc/edge_common.cuh `ladder_range`)
LADDER = ("fused_superstep", "candidates_csr", "ring_cand_phase",
          "candidate_edge_terms", "cand_dots_kb")
RING_DP = 4
RING_ODD_DP = 3
RING_ODD_K = (37, 1024)
SINGLE_PASS = ("fused_superstep", "grad_llh_csr", "candidates_csr")
K_BLOCKED = ("edge_dots_kb", "grad_from_x", "cand_dots_kb", "cand_from_x")
# the launch counter of a KERNELS entry where it is not the entry's name
COUNTER = {"cand_from_x": "cand_select_from_x"}
NO_LIBRARY = (
    "no single PyTorch call computes this function (gather, clipped "
    "log-survival edge terms and per-node sums, and for the candidate "
    "kernels the 16-step Armijo ladder)"
)
LIBRARY_NOTES = {
    "edge_dots_kb": (
        "torch.sparse.sampled_addmm(A, F, F.T) on the graph's CSR pattern: "
        "every edge's full dot F_u.F_v in one call (all K blocks at once)"
    ),
    "grad_from_x": (
        "no single PyTorch call: a sparse product gives sum_v F_v/omp only "
        "after the edge terms are formed, and not the LLH or the fold"
    ),
    "cand_dots_kb": (
        "no single PyTorch call: each of the 16 clipped candidate rows "
        "would need its own sampled product"
    ),
    "cand_from_x": (
        "no single PyTorch call: the clipped log-survival terms come "
        "before the per-node sum (index_add_), and the 16 clipped candidate "
        "rows, their dots, the test and the selection are further calls"
    ),
    "armijo_tail_select": (
        "no single PyTorch call forms the 16 clipped candidate rows, their "
        "dots with F_u - sumF, the acceptance test and the selection"
    ),
    "member_lookup": (
        "no single PyTorch call: torch.searchsorted gives positions only; "
        "the hit test, the sentinel mask and the weight gather are further "
        "calls"
    ),
    "candidate_edge_terms": (
        "no single PyTorch call forms the 16 clipped candidate rows and "
        "their log-survival edge terms"
    ),
    "cand_sweep": (
        "no single PyTorch call: the member lookup, the 16 clipped candidate "
        "rows, their dots, the log-survival terms and the per-node sums"
    ),
    "ring_grad_phase": (
        "none: no single PyTorch call forms the per-edge survival terms, "
        "the neighbour-gradient and LLH sums and their addition to the "
        "accumulator"
    ),
    "ring_cand_phase": (
        "none: no single PyTorch call forms the 16 clipped candidate rows, "
        "their log-survival edge terms and per-node sums"
    ),
}


# --against: other trees' kernel libraries by directory, {"lib": the bound
# library, "kernels": the KERNELS names to set beside this tree's}; and the
# side_by_side results, {kernel: {directory: {...}}}
AGAINST = {}
SIDE = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Check:
    """Accumulates the kernel-vs-plain comparison of one kernel."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.parts = {}

    def close(self, what, got, want):
        got, want = got.double(), want.double()
        if got.numel() == 0:
            return
        err = (got - want).abs()
        excess = float((err - (ATOL + RTOL * want.abs())).max())
        abs_err = float(err.max())
        rel = float((err / (want.abs() + ATOL)).max())
        self.max_abs = max(self.max_abs, abs_err)
        self.max_rel = max(self.max_rel, rel)
        prev = self.parts.get(what, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        self.parts[what] = {"max_abs_err": max(prev["max_abs_err"], abs_err),
                            "max_rel_err": max(prev["max_rel_err"], rel)}
        if not (excess <= 0.0 and torch.isfinite(got).all()):
            raise AssertionError(
                f"{self.name}: {what} disagrees with the plain version "
                f"(max abs err {abs_err}, beyond tolerance by {excess})"
            )

    def equal(self, what, got, want):
        """Bit-for-bit equality, for an exact function."""
        abs_err = (
            float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        )
        self.max_abs = max(self.max_abs, abs_err)
        prev = self.parts.get(what, {"max_abs_err": 0.0, "checked": 0})
        self.parts[what] = {"max_abs_err": max(prev["max_abs_err"], abs_err),
                            "checked": prev["checked"] + got.numel()}
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(
                f"{self.name}: {what} is not bit-equal to the plain version "
                f"(max abs err {abs_err})"
            )

    def ok_mask(self, ok_k, ok_p, cand, thr, what="ok"):
        """Acceptance masks equal except at near-ties."""
        diff = ok_k != ok_p
        band = TIE * thr.abs().clamp_min(1.0)
        tie = (cand - thr).abs() <= band
        bad = int((diff & ~tie).sum())
        ratio = ((cand - thr).abs() / band)[diff]
        self.parts[what] = {
            "flips": int(diff.sum()), "flips_outside_ties": bad,
            # the flipped decision farthest from its threshold, in bands
            "max_flip_margin": float(ratio.max()) if ratio.numel() else 0.0,
        }
        if bad:
            s, u = (diff & ~tie).nonzero()[0].tolist()
            raise AssertionError(
                f"{self.name}: {bad} acceptance decisions differ away from "
                f"a near-tie (first: step {s}, node {u}, plain candidate "
                f"{float(cand[s, u])} vs threshold {float(thr[s, u])})"
            )


def compare_kernels(F, csr, cfg):
    """Run each kernel and its plain version on the same inputs and hold
    them to the tolerances. The plain versions run on float64 copies of the
    inputs: in float32 their own rounding (and the order of index_add_'s
    atomic sums, which changes from run to run) comes close to the
    near-tie band on a hub at K=1,024. Returns {name: Check}."""
    from bigclam_tpu_torch.ops import csr_kernels as ck
    from bigclam_tpu_torch.ops import fused

    sumF = F.sum(dim=0)
    F64, sumF64 = F.double(), sumF.double()
    checks = {n: Check(n) for n in SINGLE_PASS}
    grad_p, llh_p, cand_p, thr_p = fused.acceptance_inputs_plain(F64, sumF64, csr, cfg)

    c = checks["grad_llh_csr"]
    grad_k, llh_k = ck.grad_llh_csr(F, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("grad", grad_k, grad_p)
    c.close("node_llh", llh_k, llh_p)

    c = checks["candidates_csr"]
    grad_in = grad_p.float()
    cand_k = ck.candidates_csr(F, grad_in, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("cand", cand_k,
            ck.candidates_csr_plain(F64, grad_in.double(), sumF64, csr, cfg))
    del grad_in

    c = checks["fused_superstep"]
    Fn_k, g_k, l_k, ok_k = fused.fused_superstep(F, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("grad", g_k, grad_p)
    c.close("node_llh", l_k, llh_p)
    c.ok_mask(ok_k, cand_p >= thr_p, cand_p, thr_p)
    # every row: the plain selection and projection on the kernel's mask
    c.close("F_new", Fn_k, fused.project_accepted(F64, grad_p, ok_k, cfg))
    return checks


def kb_plain_inputs(F, csr, cfg, kc):
    """The K-blocked pass's intermediates from the plain versions: the full
    dots x, the folded gradient windows and the full candidate dots xc."""
    from bigclam_tpu_torch.ops import kblocked as kb

    sumF = F.sum(dim=0)
    e, k_pad = csr.num_directed_edges, F.shape[1]
    x = torch.zeros(e, device=F.device)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb_plain(F, csr, col0, kc, x)
    grads, llh = [], None
    for col0 in range(0, k_pad, kc):
        g, ln = kb.grad_from_x_kb_plain(x, F, sumF, csr, col0, kc, cfg, True)
        grads.append(g)
        llh = ln if col0 == 0 else llh
    xc = torch.zeros((len(cfg.step_candidates), e), device=F.device)
    for col0, g in zip(range(0, k_pad, kc), grads):
        kb.cand_dots_kb_plain(F, g, csr, col0, kc, cfg, xc)
    return sumF, x, grads, llh, xc


def compare_kb_kernels(F, csr, cfg, kc, plain):
    """Each K-blocked kernel against its plain version on the same inputs
    (`plain` = kb_plain_inputs(...)), over every K block; the dots also
    symmetric bit for bit (x[e] == x[rev[e]]); the gradient kernel with the
    fold (csr_fused_kb), written into its window of an (n, K_pad) gradient
    as the pass writes it, and without the fold (csr_grouped_kb) into a
    matrix of its own. Returns {name: Check}."""
    from bigclam_tpu_torch.ops import kblocked as kb

    sumF, x_p, grads_p, llh_p, xc_p = plain
    k_pad = F.shape[1]
    checks = {n: Check(n) for n in K_BLOCKED}
    x_k = torch.zeros_like(x_p)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x_k)
    torch.cuda.synchronize()
    checks["edge_dots_kb"].close("x", x_k, x_p)
    rev = (csr.rev if csr.rev is not None else kb.reverse_edges(csr)).long()
    checks["edge_dots_kb"].equal("x_rev", x_k[rev], x_k)
    c = checks["grad_from_x"]
    grad = torch.empty_like(F)
    for col0, g_p in zip(range(0, k_pad, kc), grads_p):
        g_k, l_k = kb.grad_from_x_kb(x_p, F, sumF, csr, col0, kc, cfg, True,
                                     out=grad[:, col0 : col0 + kc])
        torch.cuda.synchronize()
        c.close("grad_fold", g_k, g_p)
        if col0 == 0:
            c.close("llh_nbr", l_k, llh_p)
        elif l_k is not None:
            raise AssertionError("grad_from_x wrote llh_nbr past block 0")
        g_k, _ = kb.grad_from_x_kb(x_p, F, sumF, csr, col0, kc, cfg, False)
        g_n, _ = kb.grad_from_x_kb_plain(x_p, F, sumF, csr, col0, kc, cfg, False)
        torch.cuda.synchronize()
        c.close("grad_no_fold", g_k, g_n)
    xc_k = torch.zeros_like(xc_p)
    for col0, g_p in zip(range(0, k_pad, kc), grads_p):
        kb.cand_dots_kb(F, g_p, csr, col0, kc, cfg, xc_k)
    torch.cuda.synchronize()
    checks["cand_dots_kb"].close("xc", xc_k, xc_p)
    out_k = kb.cand_nbr_from_x(xc_p, csr, cfg)
    torch.cuda.synchronize()
    checks["cand_from_x"].close("cand_nbr", out_k, kb.cand_nbr_from_x_plain(xc_p, csr, cfg))
    check_node_pass(checks["cand_from_x"], "node", xc_p, F, sumF,
                    torch.cat(grads_p, dim=1), llh_p, csr, cfg)
    return checks


def select_plain(F, sumF, grad, node_llh, cand_nbr, cfg):
    """What the node pass's acceptance test compares, in float64: (cand
    (S, n), the neighbour sums plus the Armijo tails; thr (S, n), node_llh +
    float32(alpha eta) ||g||^2, the threshold rounded as kernel A rounds
    it)."""
    from bigclam_tpu_torch.ops.csr_kernels import kernel_constants
    from bigclam_tpu_torch.ops.linesearch import armijo_tails

    F, sumF, grad, node_llh, cand_nbr = (
        t.double() for t in (F, sumF, grad, node_llh, cand_nbr))
    coefs = torch.as_tensor(kernel_constants(cfg)["coefs"], device=F.device).double()
    gg = (grad * grad).sum(dim=1)
    return (cand_nbr + armijo_tails(F, sumF, grad, cfg),
            node_llh[None, :] + coefs[:, None] * gg[None, :])


def check_node_pass(check, tag, xc, F, sumF, grad, llh_nbr, csr, cfg):
    """The node pass (cand_select_from_x) against its plain version on
    float64 copies of the same inputs: node_llh in the 3e-5 band, the mask
    through Check.ok_mask, F_new on every row against the plain projection
    on the kernel's own mask."""
    from bigclam_tpu_torch.ops import kblocked as kb
    from bigclam_tpu_torch.ops.fused import project_accepted
    from bigclam_tpu_torch.ops.objective import node_tail

    F_new, node_llh, ok = kb.cand_select_from_x(xc, F, sumF, grad, llh_nbr, csr, cfg)
    torch.cuda.synchronize()
    F64, sumF64, grad64 = F.double(), sumF.double(), grad.double()
    node_llh_p = llh_nbr.double() + node_tail(F64, sumF64)
    check.close(f"{tag}_node_llh", node_llh, node_llh_p)
    cand, thr = select_plain(F64, sumF64, grad64, node_llh_p,
                             kb.cand_nbr_from_x_plain(xc.double(), csr, cfg), cfg)
    check.ok_mask(ok, cand >= thr, cand, thr, f"{tag}_ok")
    check.close(f"{tag}_F_new", F_new, project_accepted(F64, grad64, ok, cfg))


def check_epilogue(check, tag, F, sumF, grad, node_llh, cand_nbr, cfg):
    """The node pass's epilogue from given neighbour sums
    (armijo_tail_select) against its plain version on float64 copies of the
    same inputs, as check_node_pass holds the node pass."""
    from bigclam_tpu_torch.ops.fused import project_accepted
    from bigclam_tpu_torch.ops.linesearch import armijo_tail_select

    F_new, ok = armijo_tail_select(F, sumF, grad, node_llh, cand_nbr, cfg)
    torch.cuda.synchronize()
    cand, thr = select_plain(F, sumF, grad, node_llh, cand_nbr, cfg)
    check.ok_mask(ok, cand >= thr, cand, thr, f"{tag}_ok")
    check.close(f"{tag}_F_new", F_new,
                project_accepted(F.double(), grad.double(), ok, cfg))


def reset_launch_counts() -> None:
    from bigclam_tpu_torch.ops import (
        edge_kernels, fused, kblocked, linesearch, ring_kernels, sparse_members,
    )

    fused.reset_launch_counts()
    kblocked.reset_launch_counts()
    sparse_members.reset_launch_counts()
    edge_kernels.reset_launch_counts()
    ring_kernels.reset_launch_counts()
    linesearch.reset_launch_counts()


def launch_counts() -> dict:
    from bigclam_tpu_torch.ops import (
        edge_kernels, fused, kblocked, linesearch, ring_kernels, sparse_members,
    )

    return {**fused.launch_counts(), **kblocked.launch_counts(),
            **sparse_members.launch_counts(), **edge_kernels.launch_counts(),
            **ring_kernels.launch_counts(), **linesearch.launch_counts()}


def time_ms(fn, reps: int = 5, warm: bool = True) -> list:
    """CUDA-event times (ms) of `reps` runs of fn(), after a warm-up unless
    `warm` is False."""
    if warm:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


# a plain version whose warm-up takes this long is timed once on each side
# of the kernel's runs: at full its 12 calls took 2.2-2.4 s each, 57 s of
# `full` alone, on a script that must end in 1,200 s (PERF.md §6, PR 22)
PLAIN_SLOW_MS = 250.0


def time_pair(kern, plain, reps: int = 5) -> dict:
    """Median CUDA-event times of a kernel and its plain version over
    2 x reps runs each, taken in the order plain, kernel, kernel, plain
    (reps runs after a warm-up each), so that drift on the card hits both
    alike. A plain version whose warm-up takes PLAIN_SLOW_MS or more runs
    once on each side, with no second warm-up."""
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    reps_p = 1 if (time.perf_counter() - t0) * 1e3 >= PLAIN_SLOW_MS else reps
    p = time_ms(plain, reps_p, warm=False)
    k = time_ms(kern, reps) + time_ms(kern, reps)
    p += time_ms(plain, reps_p, warm=reps_p > 1)
    return {"ms": statistics.median(k), "plain_ms": statistics.median(p),
            "ms_runs": k, "plain_ms_runs": p}


def profile_call(fn, top: int = 8) -> dict:
    """One call of fn under torch.profiler (after a warm-up): its wall
    time, the device's busy time (the kernels' summed device time), the
    idle share of the wall time, and the aten ops and kernels with the most
    device time (an op's time includes its kernels; ops nest). The
    profiler's own overhead lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    ops = sorted((e for e in events
                  if e.device_type == DeviceType.CPU and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "ops_device_ms": {e.key: [e.device_time_total / 1e3, e.count]
                          for e in ops[:top]},
        "kernels_device_ms": {e.key[:90]: [e.self_device_time_total / 1e3, e.count]
                              for e in kernels[:top]},
    }


@contextlib.contextmanager
def using_library(lib):
    """The port's wrappers launch through the kernel library `lib` inside
    the block."""
    from bigclam_tpu_torch.ops import build

    keep, build._LIBRARY = build._LIBRARY, lib
    try:
        yield
    finally:
        build._LIBRARY = keep


def tensors(out) -> list:
    """The tensors of a (nested) result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in tensors(o)]
    return []


def side_by_side(name: str, fn, label: str = "") -> None:
    """fn() (fresh outputs on every call) under this tree's kernel library
    and under each --against library that names kernel `name`: the outputs
    compared bit for bit, and both timed as time_pair times a kernel and its
    plain version (this tree's as "ms", the other's as "against_ms"). The
    result goes to SIDE[name], or SIDE[f"{name} ({label})"] for another
    input of the same kernel."""
    for tag, other in AGAINST.items():
        if name not in other["kernels"]:
            continue

        def theirs():
            with using_library(other["lib"]):
                return fn()

        a, b = tensors(fn()), tensors(theirs())
        torch.cuda.synchronize()
        equal = len(a) == len(b) and all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
        diff = max((float((x.double() - y.double()).abs().max())
                    for x, y in zip(a, b) if x.shape == y.shape and x.numel()),
                   default=0.0)
        del a, b
        t = time_pair(fn, theirs)
        SIDE.setdefault(f"{name} ({label})" if label else name, {})[tag] = {
            "bit_equal": equal, "max_abs_diff": diff,
            "ms": t["ms"], "against_ms": t["plain_ms"],
            "ms_runs": t["ms_runs"], "against_ms_runs": t["plain_ms_runs"],
        }


def kernel_function(mangled: str) -> str:
    """`name<N>` of a mangled kernel `[namespaces::]name<N>(...)` (Itanium
    ABI: length-prefixed names, then ILi<N>E for an int template
    argument), so that two builds' anonymous namespaces compare equal."""
    nested = mangled.startswith("_ZN")
    pos, name = 3 if nested else 2, None
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        pos += len(digits)
        name = mangled[pos : pos + int(digits)]
        pos += int(digits)
        if not nested:
            break
    if name is None:
        return mangled
    t = re.match(r"ILi(\d+)E", mangled[pos:])
    return f"{name}<{t.group(1)}>" if t else name


def sass_opcodes(lib_path) -> dict:
    """{kernel function: its SASS opcodes in order (modifiers kept,
    operands and predicates dropped)} of a kernel library, from cuobjdump;
    a function is named by its kernel and template argument, e.g.
    `fused_superstep_kernel<32>`."""
    from bigclam_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = kernel_function(m.group(1))
            out[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@\S+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and fn:
            out[fn].append(m.group(1))
    return out


def phase_against(specs) -> dict:
    """Build each --against DIR=KERNELS library and set the SASS of every
    kernel function of the named kernels' sources beside this tree's."""
    from pathlib import Path

    from bigclam_tpu_torch.ops import build

    if not specs:
        return {"skipped": "no --against DIR=KERNELS given"}
    ours = sass_opcodes(build.library_path())
    out = {}
    for spec in specs:
        d, _, names = spec.partition("=")
        kernels = [k for k in names.split(",") if k]
        unknown = sorted(set(kernels) - set(KERNELS))
        if not kernels or unknown:
            raise ValueError(f"--against {spec}: name kernels of {sorted(KERNELS)}")
        res = build.build(Path(d).resolve())
        # another tree's library may lack this tree's newer C entries
        AGAINST[d] = {"lib": build.bind(res["path"], require_all=False),
                      "kernels": kernels}
        theirs = sass_opcodes(res["path"])
        stems = {source_name(k).removesuffix("_kb") for k in kernels}
        funcs = {
            f: {"instructions": len(ours.get(f, [])),
                "against_instructions": len(theirs.get(f, [])),
                "same_opcodes": ours.get(f) == theirs.get(f)}
            for f in sorted(set(ours) | set(theirs))
            if any(f.startswith(st) for st in stems)
        }
        out[d] = {
            "kernels": kernels, "build_s": res["seconds"],
            "ptxas": {k: ptxas_kernels(res["logs"].get(source_name(k), ""))
                      for k in kernels},
            "sass": funcs,
        }
    return out


def ladder_tiles(degrees) -> dict:
    """The staged ladder's tiles over whole neighbourhoods of these
    degrees, by the row groups (8 rows each) a tile with row groups runs:
    a full tile 4, the last one ceil(rows / 8). Every tile takes the same
    number of column chunks, so the shares are also the shares of stages;
    `rows_per_tile` is the edges over the tiles."""
    from bigclam_tpu_torch.ops.csr_kernels import LADDER_ROWS

    d = np.asarray(degrees, np.int64)
    d = d[d > 0]
    rem = d % LADDER_ROWS
    groups = np.bincount(-(-rem[rem > 0] // 8), minlength=5)
    groups[4] += int((d // LADDER_ROWS).sum())
    tiles = int(groups.sum())
    return {
        "tiles": tiles,
        "by_row_groups": {g: int(groups[g]) for g in range(1, 5)},
        "share": {g: float(groups[g]) / tiles for g in range(1, 5)},
        "rows_per_tile": float(d.sum()) / tiles,
    }


def bounds(n: int, e: int, k: int, s: int) -> dict:
    """Least time the card could take for each kernel's work at these
    inputs: max(bytes moved once / HBM rate, float32 operations / FP32
    peak), counting what the function needs, not what a kernel recomputes.
    Counts use the live K columns. Per directed edge: the dot and the
    gradient accumulation are 4K operations (+3 for expm1, log and the
    division), and each candidate's dot nf_s . F_v is 2K (+2); nf_s =
    clip(F_u + eta_s g_u) depends on u alone. Per node: fold + tail 6K,
    building nf_s and its tail 6K per candidate, selection 6K.

    The K-blocked kernels are counted per full step (every K block): the
    dots 2K per edge into x (E,); the gradient from x 2K (+3) per edge and
    the fold 2K per node; the candidate dots 2K (+2) per edge and
    candidate plus 3K per node and candidate to build nf_s, into xc (S, E).
    cand_from_x is the node pass that ends the step (cand_select_from_x): xc
    read once, F and the gradient read and F_new written once, the node
    LLH and the (S, n) mask written, 3 operations per edge and candidate
    from xc and per node select_bound's count; `cand_from_x_neighbour_only`
    is the neighbour sums alone (S, n)."""
    f4 = 4.0 * n * k
    csr_bytes = 8.0 * (n + 1) + 4.0 * e + 4.0 * k
    grad_ops = e * (4.0 * k + 3) + n * 6.0 * k
    cand_ops = e * s * (2.0 * k + 2) + n * s * 6.0 * k
    x_bytes, xc_bytes = 4.0 * e, 4.0 * s * e
    work = {
        "grad_llh_csr": (f4 + csr_bytes + f4 + 4.0 * n, grad_ops),
        "candidates_csr": (2 * f4 + csr_bytes + 4.0 * s * n, cand_ops),
        "fused_superstep": (
            f4 + csr_bytes + 2 * f4 + 4.0 * n + 1.0 * s * n,
            grad_ops + cand_ops + n * 6.0 * k,
        ),
        "edge_dots_kb": (f4 + csr_bytes + x_bytes, e * 2.0 * k),
        "grad_from_x": (
            x_bytes + f4 + csr_bytes + f4 + 4.0 * n,
            e * (2.0 * k + 3) + n * 2.0 * k,
        ),
        "cand_dots_kb": (
            2 * f4 + csr_bytes + xc_bytes,
            e * s * (2.0 * k + 2) + n * s * 3.0 * k,
        ),
        "cand_from_x": (
            xc_bytes + 8.0 * (n + 1) + select_bytes(n, k, s) - 4.0 * s * n + 4.0 * n,
            e * s * 3.0 + select_ops(n, k, s),
        ),
        "cand_from_x_neighbour_only": (xc_bytes + 8.0 * (n + 1) + 4.0 * s * n,
                                       e * s * 3.0),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
        out[name] = {
            "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes,
            "ops": ops,
        }
    return out


def select_bytes(n: int, k: int, s: int) -> float:
    """Bytes of the node pass's epilogue over n rows: F and g read and F_new
    written once (12 bytes a live column), sumF, node_llh and the (s, n)
    neighbour sums read, the (s, n) mask written (a byte each)."""
    return 12.0 * n * k + 4.0 * k + 4.0 * n + 4.0 * s * n + 1.0 * s * n


def select_ops(n: int, k: int, s: int) -> float:
    """Operations of the node pass's epilogue over n rows: 6 a column and
    candidate (clip(F + eta g) and its dot with F - sumF), 10 a column
    besides (||g||^2, F.F, F.sumF, F - sumF, the projection)."""
    return n * k * (6.0 * s + 10.0)


def select_bound(n: int, k: int, s: int) -> dict:
    """Least time of the node pass's epilogue from given neighbour sums
    (armijo_tail_select) over n rows at the live K."""
    nbytes, ops = select_bytes(n, k, s), select_ops(n, k, s)
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def member_bound(n: int, e: int, m: int) -> dict:
    """Least time for one member-lookup sweep over e edges at m slots: the
    n live state rows read once (ids and weights, 8 bytes a slot), src and
    dst (16 bytes an edge) and the (e, m) float32 output written once,
    over the HBM rate; the binary-search compares (log2 m + 1 per slot)
    over the float32 rate, as the card's table names no int32 rate."""
    nbytes = 8.0 * n * m + 16.0 * e + 4.0 * e * m
    ops = e * m * (math.log2(m) + 1.0)
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def cand_sweep_bound(n: int, e: int, m: int, num_s: int) -> dict:
    """Least time for one candidate sweep over e edges at m slots: the
    source rows (ids, weights, gradient: 12 bytes a slot) and the
    destination rows (8 bytes a slot) read once, src and dst (16 bytes an
    edge), the (S, n) float32 sums written once, over the HBM rate; the
    lookup's compares (log2 m + 1 a slot) and the candidates' dots (2m + 2
    an edge and candidate) over the float32 rate."""
    nbytes = 20.0 * n * m + 16.0 * e + 4.0 * num_s * n
    ops = e * m * (math.log2(m) + 1.0) + e * num_s * (2.0 * m + 2.0)
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def edge_terms_bound(n: int, e: int, k: int, s: int) -> dict:
    """Least time for one candidate edge-terms sweep over e edges: F and
    grad (n, k) read once, src/dst (16 bytes an edge) and the (s, e)
    float32 output written once, over the HBM rate; one 2K dot and the
    edge term (+2) per edge and candidate over the float32 rate (nf_s
    depends on the source node alone)."""
    nbytes = 8.0 * n * k + 16.0 * e + 4.0 * s * e
    ops = e * s * (2.0 * k + 2)
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def wall(fn, *a, **kw):
    """(fn's result, its seconds on the host clock, the card synchronized
    after it)."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def native_status() -> dict:
    """The native host library's status; raises unless it loaded."""
    from bigclam_tpu_torch.graph import native

    st = native.status()
    if not st["loaded"]:
        raise AssertionError(f"the native host library did not load: {st['reason']}")
    return st


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    CARD["nvidia_smi"] = smi
    return {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }


def ptxas_kernels(log: str) -> dict:
    """{kernel function (mangled): {"registers", "spill_stores",
    "spill_loads"}} from one source's `ptxas -v` report."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?$",
                      ln.strip())
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return {f: v for f, v in out.items() if "registers" in v}


def source_name(kernel: str) -> str:
    """The csrc/ source (build.SOURCES name) of a KERNELS entry."""
    return os.path.basename(KERNELS[kernel]["source"]).removesuffix(".cu")


def phase_build() -> dict:
    from bigclam_tpu_torch.ops import build
    from bigclam_tpu_torch.ops.csr_kernels import ladder_launch_plan

    res = build.build()
    regs = {
        name: [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "properties for" in ln
        ]
        for name, log in res["logs"].items()
    }
    # the redesigned kernels per instantiation (KPL bucket of the ladder
    # and staged-gradient kernels; C, #9, #14 and cand_dots_kb have one for
    # all K; the member lookup's lane groups and spans by M)
    redesigned = {name: ptxas_kernels(res["logs"][source_name(name)])
                  for name in KERNELS if "redesigned" in KERNELS[name]
                  and source_name(name) in res["logs"]}
    plans = {name: {k: ladder_launch_plan(name, k) for k in (32, 64, 128, 256, 512, 1024)}
             for name in LADDER}
    return {"build_s": res["seconds"], "cached": res["cached"],
            "redesigned_ptxas": redesigned, "ladder_plan": plans, "ptxas": regs}


def odd_graph():
    """Planted blocks plus isolated nodes (the odd case's graph)."""
    from bigclam_tpu_torch.graph.ingest import graph_from_edges
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    o = ODD
    g0, _ = sample_planted_graph(
        o["n"], o["blocks"], p_in=o["p_in"], rng=np.random.default_rng(o["seed"])
    )
    pairs = np.stack([g0.src, g0.dst], axis=1)
    return graph_from_edges(pairs, num_nodes=o["n"] + o["isolated"])


def hub_graph():
    """Planted blocks plus two hubs, node i joined to HUB["degrees"][i]
    random nodes (the ladder kernels walk them in many 32-neighbour tiles),
    plus isolated nodes."""
    from bigclam_tpu_torch.graph.ingest import graph_from_edges
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    h = HUB
    rng = np.random.default_rng(h["seed"])
    g0, _ = sample_planted_graph(h["n"], h["blocks"], p_in=h["p_in"], rng=rng)
    pairs = [np.stack([g0.src, g0.dst], axis=1)]
    for hub, deg in enumerate(h["degrees"]):
        nbrs = rng.choice(np.setdiff1d(np.arange(h["n"]), [hub]), deg, replace=False)
        pairs.append(np.stack([np.full(deg, hub), nbrs], axis=1))
    g = graph_from_edges(np.concatenate(pairs), num_nodes=h["n"] + h["isolated"])
    if g.degrees[0] < h["degrees"][0] or g.degrees[1] < h["degrees"][1]:
        raise AssertionError(f"hub degrees {g.degrees[:2]}")
    return g


def odd_case(k: int = ODD["k"], g=None):
    """Planted blocks plus isolated nodes at K=37 (not a multiple of 32;
    or the K given; or the graph given), with an all-zero F row."""
    from bigclam_tpu_torch.config import BigClamConfig

    o = ODD
    g = odd_graph() if g is None else g
    F = np.random.default_rng(o["seed"] + 1).uniform(0.0, 1.0, (g.num_nodes, k))
    F[7] = 0.0
    cfg = BigClamConfig(num_communities=k)
    dev = torch.device(DEVICE)
    return torch.as_tensor(F, dtype=torch.float32, device=dev), g.to_device(dev), cfg


def phase_odd() -> dict:
    F, csr, cfg = odd_case()
    checks = compare_kernels(F, csr, cfg)
    out = {
        "n": int(F.shape[0]), "k": int(F.shape[1]),
        "kernels": {n: c.parts for n, c in checks.items()},
    }
    g = hub_graph()
    for k in HUB_K:
        F, csr, cfg = odd_case(k, g)
        checks = compare_kernels(F, csr, cfg)
        out[f"hub_k{k}"] = {n: c.parts for n, c in checks.items()}
    out["hub"] = {"n": g.num_nodes, "degrees": [int(d) for d in g.degrees[:2]],
                  "directed_edges": g.num_directed_edges}
    return out


def fit_args(extra):
    from bigclam_tpu_torch import cli

    return cli.build_parser().parse_args(["fit", "--quiet", *extra])


def decimal_columns(x) -> tuple:
    """Non-negative integers as right-aligned ASCII digits: a (len(x),
    width) uint8 matrix and the mask of each row's digits."""
    x = np.asarray(x, np.int64)
    width = len(str(int(x.max()))) if x.size else 1
    digits = np.empty((x.size, width), np.uint8)
    rest = x.copy()
    for j in range(width - 1, -1, -1):
        digits[:, j] = rest % 10 + 48
        rest //= 10
    count = np.ones(x.size, np.int64)
    for j in range(1, width):
        count += x >= 10 ** j
    return digits, np.arange(width)[None, :] >= width - count[:, None]


def write_edge_list(path, src, dst) -> None:
    """`src[i] dst[i]` a line, as np.savetxt(fmt="%d") writes them, built in
    bulk (savetxt formats each line in Python: 5-8 s at full)."""
    a, a_keep = decimal_columns(src)
    b, b_keep = decimal_columns(dst)
    n = a.shape[0]
    sep = np.full((n, 1), ord(" "), np.uint8)
    end = np.full((n, 1), ord("\n"), np.uint8)
    keep = np.ones((n, 1), bool)
    lines = np.concatenate([a, sep, b, end], axis=1)
    mask = np.concatenate([a_keep, keep, b_keep, keep], axis=1)
    with open(path, "wb") as f:
        f.write(lines[mask].tobytes())


def planted_file(cfg, path):
    """Sample an AGM planted graph and write it to `path` as a SNAP edge
    list (each undirected edge once); returns the sampled Graph."""
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    g, _ = sample_planted_graph(
        cfg["n"], cfg["k"], p_in=cfg["p_in"],
        rng=np.random.default_rng(cfg["seed"]),
    )
    once = g.src < g.dst
    write_edge_list(path, g.src[once], g.dst[once])
    return g


def run_path(g, path, k, extra, out_path=None):
    """`cli fit --graph path --k k` (g is the graph written there; with
    `--out out_path` when given) with every launch counter zeroed just
    before it and read just after."""
    from bigclam_tpu_torch import cli

    args = fit_args([
        "--graph", path, "--k", str(k), "--init", "conductance",
        "--conv-tol", "0", "--device", DEVICE,
        *(["--out", out_path] if out_path else []), *extra,
    ])
    reset_launch_counts()
    out, res, state = cli.fit(args)
    counts = launch_counts()
    if (out["n"], out["edges"]) != (g.num_nodes, g.num_edges):
        raise AssertionError(
            f"ingest read {out['n']} nodes / {out['edges']} edges, the file "
            f"holds {g.num_nodes} / {g.num_edges}"
        )
    hist = out["llh_history"]
    if not all(math.isfinite(v) for v in hist):
        raise AssertionError(f"non-finite LLH in {hist}")
    if res.F.shape != (g.num_nodes, k) or not np.isfinite(res.F).all():
        raise AssertionError("fit returned a malformed F")
    return out, res, counts, state


def plain_writer_bytes(F, g, head: int) -> tuple:
    """The plain writer's file for F and g, every line, built in bulk on
    DEVICE: membership_mask's (node, community) pairs (nonzero, node-major,
    as extract_communities takes them) sorted by (community, raw id) as
    one int64 key, each raw id's decimal digits taken from its value, a
    tab after each member but the last of its community and a newline
    after that. Returns the bytes (uint8), the non-empty communities and
    the raw ids of the first `head` of them."""
    from bigclam_tpu_torch.ops.extraction import delta_threshold, membership_mask

    mask = torch.from_numpy(
        membership_mask(F, delta_threshold(g.num_nodes, g.num_edges))).to(DEVICE)
    pairs = torch.nonzero(mask)                     # (node, community) rows
    del mask
    raw = np.asarray(g.raw_ids, dtype=np.int64)
    if raw.min() < 0:
        raise AssertionError(f"a negative raw id {raw.min()}")
    n = raw.size
    by_raw = np.argsort(raw, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[by_raw] = np.arange(n)
    key = pairs[:, 1] * n + torch.from_numpy(rank).to(DEVICE)[pairs[:, 0]]
    del pairs
    key = torch.sort(key).values
    comm, r = key // n, key % n
    del key
    live = torch.unique_consecutive(comm)
    # each raw id (in raw-id order) right-aligned in w digit columns, then
    # a separator column
    raw_sorted = raw[by_raw]
    w = len(str(int(raw_sorted[-1])))
    width = np.ones(n, dtype=np.int8)
    for d in range(1, w):
        width += raw_sorted >= 10 ** d
    table = np.zeros((n, w + 1), dtype=np.uint8)
    table[:, :w] = ord("0") + raw_sorted[:, None] // 10 ** np.arange(w - 1, -1, -1) % 10
    rows = torch.from_numpy(table).to(DEVICE)[r]
    last = torch.ones(r.numel(), dtype=torch.bool, device=DEVICE)
    last[:-1] = comm[1:] != comm[:-1]
    rows[:, w] = torch.where(last, ord("\n"), ord("\t")).to(torch.uint8)
    del last
    first = {}
    for c in live[:head].tolist():
        lo, hi = torch.searchsorted(
            comm, torch.tensor([c, c + 1], device=DEVICE)).tolist()
        first[c] = raw_sorted[r[lo:hi].cpu().numpy()].tolist()
    used = (torch.arange(w + 1, device=DEVICE)[None, :]
            >= (w - torch.from_numpy(width).to(DEVICE)[r])[:, None])
    del comm, r
    return rows[used].cpu().numpy(), live.cpu().numpy(), first


# communities save_communities itself writes, at the head of the file
WRITER_PIN_LINES = 3


def hold_writer(cpath, F, g) -> dict:
    """The array writer's file against the plain writer's, every byte:
    plain_writer_bytes for the same F and graph, whose first
    WRITER_PIN_LINES lines are those save_communities writes for the same
    communities."""
    from bigclam_tpu_torch.ops.extraction import save_communities

    want, live, head = plain_writer_bytes(F, g, WRITER_PIN_LINES)
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    pin = cpath + ".plain_head"
    save_communities(pin, head)
    pinned = np.fromfile(pin, dtype=np.uint8)
    os.remove(pin)
    if not np.array_equal(pinned, want[:pinned.size]):
        raise AssertionError("the bulk plain bytes are not save_communities' "
                             f"for the first {len(head)} communities")
    got = np.fromfile(cpath, dtype=np.uint8)
    if got.size != want.size or not np.array_equal(got, want):
        m = min(got.size, want.size)
        diff = np.flatnonzero(got[:m] != want[:m])
        at = int(diff[0]) if diff.size else m
        line = int(np.count_nonzero(want[:at] == ord("\n"))) + 1
        raise AssertionError(
            f"communities.txt ({got.size} bytes) differs from the plain "
            f"writer's ({want.size} bytes) first at byte {at}, line {line}")
    return {"lines": int(live.size), "bytes": int(want.size), "bytes_equal": True,
            "save_communities_lines": len(head)}


def phase_main(g, path, tmp):
    status = native_status()
    cpath = os.path.join(tmp, "communities.txt")
    out, res, counts, state = run_path(g, path, FULL["k"], ["--max-iters", "5"], cpath)
    hist = out["llh_history"]
    if out["kernel_path"] != "csr_fused":
        raise AssertionError(f"main path ran {out['kernel_path']}")
    if counts["fused_superstep"] != out["steps"] or counts["fused_superstep"] < 1:
        raise AssertionError(f"fused kernel launches {counts} vs {out['steps']} steps")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    # the array writer's file against the plain writer's, every byte
    held, plain_s = wall(hold_writer, cpath, res.F, g)
    sha, size = file_sha256(cpath), os.path.getsize(cpath)
    e = g.num_directed_edges
    stages = out["stage_seconds"]
    return out, res, counts, state, {
        "kernel_path": out["kernel_path"],
        "llh_history": hist,
        "steps": out["steps"],
        "iters": out["iters"],
        "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "native": status,
        "stage_seconds": stages,
        "host_stages_s": {name: stages[name] for name in BEFORE_STAGE_SECONDS},
        "host_stages_s_before": BEFORE_STAGE_SECONDS,
        "communities": out["communities"],
        "communities_bytes": size,
        "communities_sha256": sha,
        "plain_writer": {**held, "hold_s": plain_s},
        "launches": counts,
        "n": g.num_nodes, "directed_edges": e, "k": FULL["k"],
        "max_degree": int(g.degrees.max()),
    }


def phase_host_full(g, path, state, F_host) -> dict:
    """The host stages of `cli fit` at full, each against its plain
    version: the parse, the exact triangle counts, the capped estimator
    (native, numpy and sampled_device on the card, at HOST_CAP and, exact,
    at HOST_EXACT_CAP) and the device extraction of main's F on the card
    against the host one."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph import native
    from bigclam_tpu_torch.graph.ingest import graph_from_edges, parse_bytes
    from bigclam_tpu_torch.ops import extraction, seeding

    out = {}
    pairs, native_s = wall(native.parse_edge_list, path)

    def plain_parse():
        with open(path, "rb") as f:
            return parse_bytes(f.read(), path)

    plain, plain_s = wall(plain_parse)
    if not np.array_equal(pairs, plain):
        raise AssertionError("the native parse differs from parse_bytes")
    gi, csr_s = wall(graph_from_edges, pairs)
    out["parse"] = {"pairs": int(pairs.shape[0]), "native_s": native_s,
                    "parse_bytes_s": plain_s, "equal": True,
                    "graph_from_edges_s": csr_s}
    del pairs, plain

    # the seeding stage of `cli fit` (exact counts), part by part
    exact, exact_s = wall(native.triangle_counts, g)
    cfg = BigClamConfig(num_communities=FULL["k"])
    phi, phi_s = wall(seeding.conductance, gi, backend="numpy")
    seeds, rank_s = wall(seeding.rank_seeds, gi, phi, cfg)
    _, init_s = wall(seeding.init_F, gi, seeds, cfg)
    out["exact_triangles"] = {"native_s": exact_s,
                              "triangles": int(exact.sum()) // 3}
    out["seeding_split_s"] = {"conductance": phi_s, "rank_seeds": rank_s,
                              "init_F": init_s}
    del gi, phi, seeds

    cap = HOST_CAP
    if not int(g.degrees.max()) > cap:
        raise AssertionError(f"cap {cap} does not bind (max degree {g.degrees.max()})")
    rng_seed = FULL["seed"]
    seed = int(np.random.default_rng(rng_seed).integers(2**63))
    nat, nat_s = wall(native.triangle_counts_capped, g, cap, seed)
    npy, npy_s = wall(seeding.triangle_counts_sampled, g, cap,
                      np.random.default_rng(rng_seed), use_native=False)
    dev, dev_s = wall(seeding.triangle_counts_sampled_device, g, cap, seed,
                      device=DEVICE)
    np.testing.assert_allclose(npy, nat, rtol=HOST_RTOL_NATIVE, atol=HOST_RTOL_NATIVE)
    np.testing.assert_allclose(dev, nat, rtol=HOST_RTOL_DEVICE, atol=HOST_RTOL_DEVICE)
    ranks = [seeding.rank_seeds(g, seeding.conductance(g, tri=t), cfg)
             for t in (nat, npy, dev)]
    for r in ranks[1:]:
        if not np.array_equal(r, ranks[0]):
            raise AssertionError("capped estimates rank the seeds differently")
    rel = lambda a: float(np.max(np.abs(a - nat) / (np.abs(nat) + HOST_RTOL_DEVICE)))
    out["capped"] = {
        "cap": cap, "native_s": nat_s, "numpy_s": npy_s,
        "sampled_device_s": dev_s, "numpy_max_rel_err": rel(npy),
        "sampled_device_max_rel_err": rel(dev), "rank_seeds_equal": True,
        "max_abs_vs_exact": float(np.max(np.abs(nat - exact))),
    }
    del nat, npy, dev
    full_cap, full_s = wall(seeding.triangle_counts_sampled_device, g,
                            HOST_EXACT_CAP, seed, device=DEVICE)
    if not np.array_equal(full_cap, exact.astype(np.float64)):
        raise AssertionError(f"sampled_device at cap {HOST_EXACT_CAP} is not exact")
    out["capped_exact"] = {"cap": HOST_EXACT_CAP, "sampled_device_s": full_s,
                           "equal_to_exact": True}

    k = FULL["k"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dev_arr, dev_s = wall(extraction.extract_community_arrays_device, state.F, g,
                          num_communities=k)
    peak = torch.cuda.max_memory_allocated() - base
    host_arr, host_s = wall(extraction.extract_community_arrays, F_host, g)
    for name in ("ids", "offsets", "nodes"):
        if not np.array_equal(getattr(dev_arr, name), getattr(host_arr, name)):
            raise AssertionError(f"device extraction {name} differ from the host's")
    out["extract"] = {
        "pairs": int(host_arr.nodes.size), "communities": len(host_arr),
        "device_s": dev_s, "host_s": host_s, "equal_pairs": True,
        "device_peak_gb_over_state": peak / 1e9,
        "chunk_rows": min(1 << 16, (1 << 27) // k),
    }
    return out


def phase_host_odd() -> dict:
    """The dense backend on the card against the exact counts on the hub
    graph and the parity graph (the native library built and the dense
    product run once before the timed calls)."""
    from bigclam_tpu_torch.graph import native
    from bigclam_tpu_torch.models.agm import sample_planted_graph
    from bigclam_tpu_torch.ops import seeding

    p = PARITY
    parity, _ = sample_planted_graph(p["n"], p["k"], p_in=p["p_in"],
                                     rng=np.random.default_rng(p["seed"]))
    out = {"native": native_status()}
    seeding.triangle_counts_dense_device(parity, DEVICE)
    for name, g in (("hub", hub_graph()), ("parity", parity)):
        got, dense_s = wall(seeding.triangle_counts_dense_device, g, DEVICE)
        want, native_s = wall(native.triangle_counts, g)
        if not np.array_equal(got, want):
            raise AssertionError(f"dense counts differ from the exact ones on {name}")
        out[name] = {"n": g.num_nodes, "max_degree": int(g.degrees.max()),
                     "dense_s": dense_s, "native_s": native_s, "equal": True}
    return out


def phase_host_xlk(g) -> dict:
    """The numpy triangle loop against the native pass on the xl_k graph."""
    from bigclam_tpu_torch.graph import native
    from bigclam_tpu_torch.ops import seeding

    nat, native_s = wall(native.triangle_counts, g)
    npy, numpy_s = wall(seeding.triangle_counts_numpy, g)
    if not np.array_equal(nat, npy):
        raise AssertionError("native triangle counts differ from the numpy loop")
    return {"n": g.num_nodes, "native_s": native_s, "numpy_s": numpy_s,
            "equal": True, "triangles": int(nat.sum()) // 3}


def phase_split(g, path, tmp, main_hist):
    out, _, counts, _ = run_path(
        g, path, FULL["k"], ["--max-iters", "1", "--csr-fused", "off"],
        os.path.join(tmp, "communities.txt"),
    )
    hist = out["llh_history"]
    if out["kernel_path"] != "csr":
        raise AssertionError(f"split path ran {out['kernel_path']}")
    if counts["grad_llh_csr"] < 2 or counts["candidates_csr"] < 2:
        raise AssertionError(f"split kernel launches {counts}")
    for a, b in zip(hist[:2], main_hist[:2]):
        if abs(a - b) > LLH_RTOL * abs(b):
            raise AssertionError(f"split LLH {hist} vs fused {main_hist}")
    return counts, {
        "kernel_path": out["kernel_path"], "llh_history": hist,
        "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"], "launches": counts,
    }


def c_on_f0(F, csr, cfg) -> dict:
    """Kernel C and its float32 plain version, each against the float64
    plain version, on F (the conductance-init F0, where C once missed the
    float64 version by 1.1e-4 beyond the 3e-5 band): the largest absolute
    error, the same in float32 ulps of the float64 value (of 1 below 1),
    the largest excess over the band and how many values lie outside it. C
    no further outside the band than the float32 plain version is
    float32's limit, not a fault of the kernel."""
    from bigclam_tpu_torch.ops import csr_kernels as ck

    sumF = F.sum(dim=0)
    F64, sumF64 = F.double(), sumF.double()
    grad = ck.grad_llh_csr_plain(F64, sumF64, csr, cfg)[0].float()
    want = ck.candidates_csr_plain(F64, grad.double(), sumF64, csr, cfg)
    got = {"kernel": ck.candidates_csr(F, grad, sumF, csr, cfg),
           "plain_f32": ck.candidates_csr_plain(F, grad, sumF, csr, cfg)}
    torch.cuda.synchronize()
    band = ATOL + RTOL * want.abs()
    # float32 spacing at |want|, and at 1 below 1 (near 0 it would vanish)
    w32 = want.float().abs().clamp_min(1.0)
    ulp = (torch.nextafter(w32, torch.full_like(w32, math.inf)) - w32).double()
    out = {}
    for name, c in got.items():
        err = (c.double() - want).abs()
        out[name] = {"max_abs_err": float(err.max()),
                     "max_ulps": float((err / ulp).max()),
                     "max_excess": float((err - band).max()),
                     "outside_band": int((err > band).sum())}
    out["largest_abs_cand"] = float(want.abs().max())
    return out


def phase_full(g, F_host, F0):
    """Kernels vs plain at the main path's shapes (the main fit's final F),
    then timed; kernel C and its float32 plain version against float64 on
    the conductance F0."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.ops import csr_kernels as ck
    from bigclam_tpu_torch.ops import fused

    cfg = BigClamConfig(num_communities=FULL["k"])
    model = BigClamModel(g, cfg, device=DEVICE)
    F = model.init_state(F_host).F
    csr = model.csr
    checks = compare_kernels(F, csr, cfg)
    c_f0 = c_on_f0(model.init_state(F0).F, csr, cfg)
    sumF = F.sum(dim=0)
    grad, _ = ck.grad_llh_csr_plain(F, sumF, csr, cfg)
    calls = {
        "fused_superstep": (
            lambda: fused.fused_superstep(F, sumF, csr, cfg),
            lambda: fused.fused_superstep_plain(F, sumF, csr, cfg),
        ),
        "grad_llh_csr": (
            lambda: ck.grad_llh_csr(F, sumF, csr, cfg),
            lambda: ck.grad_llh_csr_plain(F, sumF, csr, cfg),
        ),
        "candidates_csr": (
            lambda: ck.candidates_csr(F, grad, sumF, csr, cfg),
            lambda: ck.candidates_csr_plain(F, grad, sumF, csr, cfg),
        ),
    }
    times = {name: time_pair(kern, plain) for name, (kern, plain) in calls.items()}
    for name in SINGLE_PASS:
        side_by_side(name, calls[name][0])
    bnd = bounds(g.num_nodes, g.num_directed_edges, FULL["k"],
                 len(cfg.step_candidates))
    return checks, times, bnd, {
        "kernels": {
            n: {**checks[n].parts, **times[n], **bnd[n]} for n in SINGLE_PASS
        },
        "k_pad": int(F.shape[1]),
        "ladder_tiles": ladder_tiles(g.degrees),
        "candidates_csr_on_f0": c_f0,
    }


def phase_parity(tmp) -> dict:
    from bigclam_tpu_torch import cli

    path = os.path.join(tmp, "parity_graph.txt")
    planted_file(PARITY, path)
    base = ["--graph", path, "--k", str(PARITY["k"]), "--max-iters", "4",
            "--conv-tol", "0"]
    gpu, _, _ = cli.fit(fit_args(base + ["--device", DEVICE]))
    cpu, _, _ = cli.fit(fit_args(base + ["--device", "cpu", "--dtype", "float64"]))
    if gpu["kernel_path"] != "csr_fused" or cpu["kernel_path"] != "xla":
        raise AssertionError((gpu["kernel_path"], cpu["kernel_path"]))
    a, b = gpu["llh_history"], cpu["llh_history"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if len(a) != len(b) or rel > LLH_RTOL:
        raise AssertionError(f"card LLH {a} vs cpu float64 {b}")
    return {"gpu_llh": a, "cpu_f64_llh": b, "max_rel": rel,
            "n": gpu["n"], "edges": gpu["edges"]}


def kb_launches_want(counts, n_kb: int, steps: int) -> dict:
    """The launch counts of `steps` K-blocked steps over n_kb blocks: each
    window kernel once per block, the node pass (cand_select_from_x) once,
    nothing else (not the neighbour-only entry, not the epilogue)."""
    want = dict.fromkeys(counts, 0)
    want.update(edge_dots_kb=n_kb * steps, grad_from_x=n_kb * steps,
                cand_dots_kb=n_kb * steps, cand_select_from_x=steps)
    return want


def run_kb_path(g, path, extra, want_path):
    """`cli fit` at the xl_k K on the K-blocked path `want_path`, with its
    launch counts checked."""
    from bigclam_tpu_torch.models.bigclam import k_block_plan

    out, res, counts, _ = run_path(g, path, XLK["k"], extra)
    if out["kernel_path"] != want_path:
        raise AssertionError(f"K={XLK['k']} ran {out['kernel_path']}, want {want_path}")
    kc, k_pad = k_block_plan(XLK["k"])
    want = kb_launches_want(counts, k_pad // kc, out["steps"])
    if counts != want:
        raise AssertionError(f"{want_path} launches {counts}, want {want}")
    e = g.num_directed_edges
    return out, res, counts, {
        "kernel_path": out["kernel_path"],
        "llh_history": out["llh_history"],
        "steps": out["steps"],
        "iters": out["iters"],
        "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"],
        "launches": counts,
        "n": g.num_nodes, "directed_edges": e, "k": XLK["k"], "kc": kc,
        "k_pad": k_pad, "max_degree": int(g.degrees.max()),
    }


def phase_kb_main(g, path):
    out, res, counts, body = run_kb_path(g, path, ["--max-iters", "5"],
                                         "csr_fused_kb")
    hist = out["llh_history"]
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    return res, counts, body


def phase_kb_split(g, path, main_hist):
    out, _, counts, body = run_kb_path(
        g, path, ["--max-iters", "1", "--csr-fused", "off"], "csr_grouped_kb"
    )
    hist = out["llh_history"]
    for a, b in zip(hist[:2], main_hist[:2]):
        if abs(a - b) > LLH_RTOL * abs(b):
            raise AssertionError(f"grouped LLH {hist} vs fused {main_hist}")
    return counts, body


def phase_kb_full(g, F_host):
    """The K-blocked kernels vs plain at kb_main's shapes, timed per full
    step (the node pass also beside the torch epilogue it replaced), and
    the whole step split into the edge kernels, the node pass and the torch
    rest; the dots and the gradient again on the same graph with shuffled
    ids."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.ops import kblocked as kb
    from bigclam_tpu_torch.ops.linesearch import accept_stats, armijo_update
    from bigclam_tpu_torch.ops.objective import edge_terms, node_tail

    cfg = BigClamConfig(num_communities=XLK["k"])
    model = BigClamModel(g, cfg, device=DEVICE)
    state = model.init_state(F_host)
    F, csr, kc = state.F, model.csr, model.kc
    plain = kb_plain_inputs(F, csr, cfg, kc)
    checks = compare_kb_kernels(F, csr, cfg, kc, plain)
    sumF, x_p, grads_p, llh_p, xc_p = plain
    grad_p = torch.cat(grads_p, dim=1)
    n, k_pad = F.shape
    e, s = csr.num_directed_edges, len(cfg.step_candidates)
    cols = range(0, k_pad, kc)

    def dots(fn, F=F, csr=csr):
        x = torch.zeros(csr.num_directed_edges, device=F.device)
        for col0 in cols:
            fn(F, csr, col0, kc, x)
        return x

    def grads(fn, fold=True, F=F, sumF=sumF, csr=csr, x=x_p):
        # as the pass writes them: each window into the step's gradient
        grad = torch.empty_like(F)
        llh = [fn(x, F, sumF, csr, col0, kc, cfg, fold,
                  out=grad[:, col0 : col0 + kc])[1] for col0 in cols]
        return grad, llh[0]

    def cands(fn):
        xc = torch.zeros((s, e), device=F.device)
        for col0, g_kb in zip(cols, grads_p):
            fn(F, g_kb, csr, col0, kc, cfg, xc)
        return xc

    calls = {
        "edge_dots_kb": (lambda: dots(kb.edge_dots_kb),
                         lambda: dots(kb.edge_dots_kb_plain)),
        "grad_from_x": (lambda: grads(kb.grad_from_x_kb),
                        lambda: grads(kb.grad_from_x_kb_plain)),
        "cand_dots_kb": (lambda: cands(kb.cand_dots_kb),
                         lambda: cands(kb.cand_dots_kb_plain)),
        "cand_from_x": (
            lambda: kb.cand_select_from_x(xc_p, F, sumF, grad_p, llh_p, csr, cfg),
            lambda: kb.cand_select_from_x_plain(xc_p, F, sumF, grad_p, llh_p, csr, cfg),
        ),
    }
    times = {name: time_pair(kern, pl) for name, (kern, pl) in calls.items()}
    for name in calls:
        times[name]["library_ms"] = None
    # beside the node pass: the neighbour-only entry, and the route it
    # replaced (that entry, then the node tail and armijo_update in torch)
    times["cand_from_x"]["neighbour_only"] = time_pair(
        lambda: kb.cand_nbr_from_x(xc_p, csr, cfg),
        lambda: kb.cand_nbr_from_x_plain(xc_p, csr, cfg))

    def torch_epilogue():
        node_llh = llh_p + node_tail(F, sumF)
        return armijo_update(F, sumF, grad_p, node_llh, kb.cand_nbr_from_x(xc_p, csr, cfg),
                             cfg, with_stats=True)

    times["cand_from_x"]["torch_epilogue_ms"] = statistics.median(
        time_ms(torch_epilogue, 3))
    # device time apart from the wrapper's host work, which the event pair
    # around a call also holds (it sets the neighbour-only entry's time)
    times["cand_from_x"]["profile"] = profile_call(
        lambda: kb.cand_select_from_x(xc_p, F, sumF, grad_p, llh_p, csr, cfg), top=3)
    times["cand_from_x"]["neighbour_only"]["profile"] = profile_call(
        lambda: kb.cand_nbr_from_x(xc_p, csr, cfg), top=3)
    for name in K_BLOCKED:
        side_by_side(name, calls[name][0])
    side_by_side("grad_from_x", lambda: grads(kb.grad_from_x_kb, False), "fold off")
    # the one library call that computes a K-blocked kernel's function:
    # every edge's full dot, sampled from F F^T on the CSR pattern
    pattern = torch.sparse_csr_tensor(
        csr.indptr, csr.indices.long(), torch.zeros(e, device=F.device),
        size=(n, n), check_invariants=True,
    )
    lib_x = torch.sparse.sampled_addmm(pattern, F, F.t()).values()
    torch.cuda.synchronize()
    lib_runs = time_ms(lambda: torch.sparse.sampled_addmm(pattern, F, F.t()))
    times["edge_dots_kb"]["library_ms"] = statistics.median(lib_runs)
    times["edge_dots_kb"]["library_max_abs_err"] = float((lib_x - x_p).abs().max())
    del pattern, lib_x
    # a yardstick for the gradient's aggregation alone (not library_ms: the
    # edge terms, the fold and the LLH are further calls): the CSR carrying
    # the coefficients 1/omp(x) times F, every window at once
    coeff = torch.sparse_csr_tensor(
        csr.indptr, csr.indices.long(), 1.0 / edge_terms(x_p, cfg)[0], size=(n, n),
        check_invariants=True,
    )
    agg = torch.sparse.mm(coeff, F)
    want = grads(kb.grad_from_x_kb_plain, False)[0]
    torch.cuda.synchronize()
    times["grad_from_x"]["sparse_mm_ms"] = statistics.median(
        time_ms(lambda: torch.sparse.mm(coeff, F)))
    times["grad_from_x"]["sparse_mm_max_abs_err"] = float((agg - want).abs().max())
    del coeff, agg, want

    # the same graph and F with the ids relabelled by a seeded permutation:
    # no id locality, so the neighbour windows are not near each other in L2
    perm = np.random.default_rng(XLK["seed"]).permutation(n)
    F_s = torch.empty_like(F)
    F_s[torch.as_tensor(perm, device=F.device)] = F
    sumF_s = F_s.sum(dim=0)
    csr_s = kb.with_rev(g.permute(perm).to_device(F.device))
    x_s = dots(kb.edge_dots_kb_plain, F_s, csr_s)
    x_k = dots(kb.edge_dots_kb, F_s, csr_s)
    g_s, l_s = grads(kb.grad_from_x_kb_plain, True, F_s, sumF_s, csr_s, x_s)
    g_k, l_k = grads(kb.grad_from_x_kb, True, F_s, sumF_s, csr_s, x_s)
    torch.cuda.synchronize()
    checks["edge_dots_kb"].close("x_shuffled", x_k, x_s)
    checks["edge_dots_kb"].equal("x_rev_shuffled", x_k[csr_s.rev.long()], x_k)
    checks["grad_from_x"].close("grad_fold_shuffled", g_k, g_s)
    checks["grad_from_x"].close("llh_nbr_shuffled", l_k, l_s)
    del x_k, g_s, l_s, g_k, l_k
    shuffled = {
        "edge_dots_kb": (lambda: dots(kb.edge_dots_kb, F_s, csr_s),
                         lambda: dots(kb.edge_dots_kb_plain, F_s, csr_s)),
        "grad_from_x": (
            lambda: grads(kb.grad_from_x_kb, True, F_s, sumF_s, csr_s, x_s),
            lambda: grads(kb.grad_from_x_kb_plain, True, F_s, sumF_s, csr_s, x_s),
        ),
    }
    for name, (kern, pl) in shuffled.items():
        times[name]["shuffled_ids"] = time_pair(kern, pl)
        side_by_side(name, kern, "shuffled ids")
    del F_s, sumF_s, csr_s, x_s

    # the step: the K-blocked edge kernels, the node pass, then the column
    # sums, the histogram and the LLH in torch
    grad, llh_nbr, xc = kb.kblocked_terms(F, sumF, csr, cfg, kc)
    F_new, node_llh, ok = kb.cand_select_from_x(xc, F, sumF, grad, llh_nbr, csr, cfg)

    def torch_rest():
        return F_new.sum(dim=0), accept_stats(ok), node_llh.sum()

    med = lambda fn: statistics.median(time_ms(fn))  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    step = {
        "step_ms": med(lambda: model._step(state)),
        "kernels_ms": med(lambda: kb.kblocked_terms(F, sumF, csr, cfg, kc)),
        "node_pass_ms": med(
            lambda: kb.cand_select_from_x(xc, F, sumF, grad, llh_nbr, csr, cfg)),
        "torch_rest_ms": med(torch_rest),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    step["other_ms"] = step["step_ms"] - (
        step["kernels_ms"] + step["node_pass_ms"] + step["torch_rest_ms"])
    del grad, llh_nbr, xc, F_new, node_llh, ok
    bnd = bounds(n, e, XLK["k"], s)
    times["cand_from_x"]["neighbour_only"].update(
        bound_ms=bnd["cand_from_x_neighbour_only"]["bound_ms"])
    return checks, times, bnd, {
        "kernels": {
            name: {**checks[name].parts, **times[name], **bnd[name]}
            for name in K_BLOCKED
        },
        "step": step, "kc": kc, "k_pad": k_pad,
        "ladder_tiles": ladder_tiles(g.degrees),
    }


def kb_odd_case(k: int, csr_k_block: int = 0, g=None, step_scale: float = 1.0) -> dict:
    """The K-blocked kernels vs plain on odd_case(k, g) (isolated nodes and
    an all-zero row) padded to the K-blocked layout of k, on the Armijo
    ladder scaled by step_scale."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import k_block_plan

    F, csr, _ = odd_case(k, g)
    kc, k_pad = k_block_plan(k, csr_k_block)
    F = torch.nn.functional.pad(F, (0, k_pad - k)).contiguous()
    cfg = BigClamConfig(num_communities=k, step_scale=step_scale)
    checks = compare_kb_kernels(F, csr, cfg, kc, kb_plain_inputs(F, csr, cfg, kc))
    return {
        "n": int(F.shape[0]), "k": k, "kc": kc, "k_pad": k_pad,
        "kernels": {n: c.parts for n, c in checks.items()},
    }


def phase_kb_odd() -> dict:
    """K=1,100 (two blocks of 576) on the odd graph and on the hub graph,
    and K=37 in windows of kc=3 on the odd graph."""
    g = hub_graph()
    return {
        **kb_odd_case(KB_ODD_K),
        "hub": {**kb_odd_case(KB_ODD_K, g=g),
                "degrees": [int(d) for d in g.degrees[:2]]},
        f"kc{KB_ODD_KC}": kb_odd_case(ODD["k"], KB_ODD_KC),
    }


def compare_kb_dst(checks, tag, F, csr, F_dst, sumF, cfg, kc):
    """The K-blocked window kernels with a destination tensor F_dst (a
    shard's CSR against the gathered F, or a ring bucket against its
    rotating shard: the directed mode), and the mesh's global column sums
    sumF, against their plain versions over
    every window of F's columns: x; the gradient with the fold into its
    window of an (n, K_pad) matrix, without it, and added into random
    accumulators (the ring's accumulate mode, LLH too); xc. Each kernel
    takes float32 inputs and its plain version their float64 copies, as
    compare_kernels holds A/B/C (the fold's -sumF + F cancels at a hub,
    where a float32 plain version's own rounding nears the band)."""
    from bigclam_tpu_torch.ops import kblocked as kb

    n, k_pad = F.shape
    e = csr.num_directed_edges
    F64, Fd64, sumF64 = F.double(), F_dst.double(), sumF.double()
    x_p = torch.zeros(e, device=F.device, dtype=torch.float64)
    x_k = torch.zeros(e, device=F.device)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb_plain(F64, csr, col0, kc, x_p, Fd64)
        kb.edge_dots_kb(F, csr, col0, kc, x_k, F_dst)
    torch.cuda.synchronize()
    checks["edge_dots_kb"].close(f"{tag}_x", x_k, x_p)
    x32 = x_p.float()
    x64 = x32.double()
    c = checks["grad_from_x"]
    gen = torch.Generator(device=F.device).manual_seed(n + k_pad)
    acc0 = torch.rand((n, k_pad), device=F.device, generator=gen)
    l0 = torch.rand(n, device=F.device, generator=gen)
    acc_k, l_k = acc0.clone(), l0.clone()
    acc_p, l_p = acc0.double(), l0.double()
    grad = torch.empty_like(F)
    xc_p = torch.zeros((len(cfg.step_candidates), e), device=F.device,
                       dtype=torch.float64)
    xc_k = torch.zeros(xc_p.shape, device=F.device)
    for col0 in range(0, k_pad, kc):
        win = slice(col0, col0 + kc)
        g_p, ln_p = kb.grad_from_x_kb_plain(x64, F64, sumF64, csr, col0, kc, cfg,
                                            True, F_dst=Fd64)
        g_k, ln_k = kb.grad_from_x_kb(x32, F, sumF, csr, col0, kc, cfg, True,
                                      out=grad[:, win], F_dst=F_dst)
        g_n, _ = kb.grad_from_x_kb(x32, F, sumF, csr, col0, kc, cfg, False,
                                   F_dst=F_dst)
        g_np, _ = kb.grad_from_x_kb_plain(x64, F64, sumF64, csr, col0, kc, cfg,
                                          False, F_dst=Fd64)
        kb.grad_from_x_kb(x32, F, sumF, csr, col0, kc, cfg, False, acc_k[:, win],
                          F_dst, True, l_k)
        kb.grad_from_x_kb_plain(x64, F64, sumF64, csr, col0, kc, cfg, False,
                                acc_p[:, win], Fd64, True, l_p)
        torch.cuda.synchronize()
        c.close(f"{tag}_grad_fold", g_k, g_p)
        c.close(f"{tag}_grad_no_fold", g_n, g_np)
        if col0 == 0:
            c.close(f"{tag}_llh_nbr", ln_k, ln_p)
        g32 = g_p.float().contiguous()
        kb.cand_dots_kb_plain(F64, g32.double(), csr, col0, kc, cfg, xc_p, Fd64)
        kb.cand_dots_kb(F, g32, csr, col0, kc, cfg, xc_k, F_dst)
    torch.cuda.synchronize()
    c.close(f"{tag}_grad_accumulate", acc_k, acc_p)
    c.close(f"{tag}_llh_accumulate", l_k, l_p)
    checks["cand_dots_kb"].close(f"{tag}_xc", xc_k, xc_p)


def kbmesh_odd_case(checks, g, k: int, tag: str) -> dict:
    """Random F (row 7 zero) at K on g, padded to the mesh's K blocks at
    tp = 1 (K = 37 and 1,000 in one window of K columns, so 37 takes the
    4-byte copies; 1,100 in two of 576): the dots' directed mode against
    the pair mode on the whole graph bit for bit, then compare_kb_dst over
    every shard of a dp = 3 all-gather mesh (F_dst the gathered F) and
    every (shard, phase) bucket of the dp = 3 ring (F_dst the rotating
    shard), the empty bucket included."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan
    from bigclam_tpu_torch.ops import kblocked as kb
    from bigclam_tpu_torch.parallel.ring import shard_ring_buckets
    from bigclam_tpu_torch.parallel.sharded import device_csr, shard_edges

    dp = KBMESH_DP
    kc, k_pad = mesh_k_plan(k, 1, True)
    if not kc:
        kc = k_pad = k
    n_pad = -(-g.num_nodes // dp) * dp
    rows = n_pad // dp
    rng = np.random.default_rng(k)
    F = np.zeros((n_pad, k_pad), np.float32)
    F[: g.num_nodes, :k] = rng.uniform(0.0, 1.0, (g.num_nodes, k))
    F[7] = 0.0
    Ft = torch.as_tensor(F, device=DEVICE)
    cfg = BigClamConfig(num_communities=k)
    dev = torch.device(DEVICE)

    csr = g.to_device(dev)
    whole = Ft[: g.num_nodes].contiguous()
    x_pair = torch.zeros(csr.num_directed_edges, device=dev)
    x_dir = torch.zeros_like(x_pair)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(whole, csr, col0, kc, x_pair, directed=False)
        kb.edge_dots_kb(whole, csr, col0, kc, x_dir, directed=True)
    torch.cuda.synchronize()
    checks["edge_dots_kb"].equal(f"{tag}_directed_vs_pair", x_dir, x_pair)

    shards = shard_edges(g, dp, n_pad)
    sumF = Ft.sum(dim=0)
    sizes = []
    for i, (indptr, indices) in enumerate(shards):
        F_loc = Ft[i * rows : (i + 1) * rows]
        compare_kb_dst(checks, f"{tag}_allgather", F_loc,
                       device_csr(indptr, indices, dev), Ft, sumF, cfg, kc)
        row = []
        for r, (b_ip, b_ix) in enumerate(shard_ring_buckets(indptr, indices, i, dp, rows)):
            j = (i + r) % dp
            compare_kb_dst(checks, f"{tag}_ring", F_loc, device_csr(b_ip, b_ix, dev),
                           Ft[j * rows : (j + 1) * rows], sumF, cfg, kc)
            row.append(int(b_ix.shape[0]))
        sizes.append(row)
    return {"k": k, "kc": kc, "k_pad": k_pad, "n_pad": n_pad, "bucket_edges": sizes}


def phase_kbmesh_odd() -> dict:
    """kbmesh_odd_case on the odd graph at K = 37 and the hub graph at
    K = 37, 1,000 and 1,100."""
    checks = {n: Check(n) for n in ("edge_dots_kb", "grad_from_x", "cand_dots_kb")}
    out = {"dp": KBMESH_DP, "odd": kbmesh_odd_case(checks, odd_graph(), ODD["k"], "odd")}
    empty = min(map(min, out["odd"]["bucket_edges"]))
    if empty != 0:
        raise AssertionError(f"want an empty bucket: {out['odd']['bucket_edges']}")
    g = hub_graph()
    for k in KBMESH_HUB_K:
        out[f"hub_k{k}"] = kbmesh_odd_case(checks, g, k, f"hub_k{k}")
    out["kernels"] = {n: c.parts for n, c in checks.items()}
    return checks, out


def phase_kb_parity(tmp) -> dict:
    """csr_k_block=32 (4 blocks) on both K-blocked paths on the card
    against the CPU float64 `xla` path, from one conductance init."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    path = os.path.join(tmp, "kb_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    cfg = BigClamConfig(num_communities=PARITY["k"], max_iters=4, conv_tol=0.0,
                        csr_k_block=KB_PARITY_KC)
    F0 = cli.init_F(g, cfg, "conductance")
    cpu = BigClamModel(g, cfg.replace(dtype="float64"), device="cpu")
    if cpu.engaged_path != "xla":
        raise AssertionError(cpu.engaged_path)
    b = cpu.fit(F0).llh_history
    out = {"cpu_f64_llh": b}
    for csr_fused, want in ((None, "csr_fused_kb"), (False, "csr_grouped_kb")):
        m = BigClamModel(g, cfg.replace(csr_fused=csr_fused), device=DEVICE)
        if m.engaged_path != want:
            raise AssertionError(f"ran {m.engaged_path}, want {want}")
        reset_launch_counts()
        a = m.fit(F0).llh_history
        counts = launch_counts()
        if counts != kb_launches_want(counts, m.k_pad // m.kc, len(a)):
            raise AssertionError(f"{want} launches {counts}")
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        if len(a) != len(b) or rel > LLH_RTOL:
            raise AssertionError(f"{want} card LLH {a} vs cpu float64 {b}")
        out[want] = {"gpu_llh": a, "max_rel": rel, "launches": counts}
    out.update(n=g.num_nodes, edges=g.num_edges, k=PARITY["k"],
               kc=KB_PARITY_KC)
    return out


def sparse_cfg(k: int, m: int, **kw):
    from bigclam_tpu_torch.config import BigClamConfig

    return BigClamConfig(num_communities=k, representation="sparse",
                         sparse_m=m, **kw)


def sparse_launches(e: int, m: int, steps: int) -> int:
    """Member-lookup launches of `steps` sparse steps: one per edge chunk
    of the grad/LLH sweep (the candidate sweep is one cand_sweep launch a
    step)."""
    from bigclam_tpu_torch.ops.objective import edge_chunk_bound

    chunk = edge_chunk_bound(sparse_cfg(1, m), m, 4)
    return -(-e // chunk) * steps


def compare_member(check, what, ids, w, edges, k_pad):
    """The member-lookup kernel against its plain version on every edge
    chunk, bit for bit."""
    from bigclam_tpu_torch.ops import sparse_members as sm

    for s, d in edges.slices():
        got = sm.member_lookup_rows(ids, w, s, d, k_pad)
        want = sm.member_lookup_rows_plain(ids, w, s, d, k_pad)
        torch.cuda.synchronize()
        check.equal(what, got, want)


def phase_sparse_odd() -> dict:
    """The member kernel vs plain on the odd case's sparse state (the
    all-zero row is an all-sentinel row; rows are padded with sentinel
    rows) at M < K and M = K, before and after a support update (which
    admits members at weight 0), and on a random batch at M = 1."""
    from bigclam_tpu_torch.ops import sparse_members as sm
    from bigclam_tpu_torch.ops.objective import EdgeChunks

    F, csr, _ = odd_case()
    n, k = F.shape
    dev = F.device
    check = Check("member_lookup")
    edges = EdgeChunks(csr.src, csr.dst, 1000)      # ragged last chunk
    avg_deg = csr.num_directed_edges / n
    out = {"n": int(n), "k": int(k), "directed_edges": csr.num_directed_edges}
    for m in SPARSE_ODD_M:
        block_b = sm.pick_block_b(1 << 22, n, m, avg_deg)
        n_pad = -(-n // block_b) * block_b
        ids, w, truncated = sm.from_dense(F.double().cpu().numpy(), m, k, n_pad)
        ids, w = torch.as_tensor(ids, device=dev), torch.as_tensor(w, device=dev).float()
        if not bool((ids[7] == k).all()):
            raise AssertionError("the all-zero row is not all sentinel")
        compare_member(check, f"m{m}_init", ids, w, edges, k)
        blocks = sm.build_support_blocks(_host_graph(csr), n_pad, block_b, device=dev)
        ids2, w2 = sm.support_update(ids, w, blocks, m, k)
        compare_member(check, f"m{m}_support", ids2, w2, edges, k)
        out[f"m{m}"] = {"truncated": truncated, "n_pad": n_pad,
                        "zero_weight_members": int(((ids2 < k) & (w2 == 0)).sum())}
    rng = np.random.default_rng(ODD["seed"])
    ids = torch.as_tensor(rng.integers(0, k + 1, (n, 1)), dtype=torch.int32, device=dev)
    w = torch.as_tensor(rng.random((n, 1)), dtype=torch.float32, device=dev)
    w[ids == k] = 0.0
    src = torch.as_tensor(rng.integers(0, n, 10_001), device=dev)
    dst = torch.as_tensor(rng.integers(0, n, 10_001), device=dev)
    compare_member(check, "m1_random", ids, w, EdgeChunks(src, dst, 10_001), k)
    # the staged search: random member rows of SPARSE_SEARCH_K ids on the
    # graph's edges, 4-byte copies at M=37 and 16-byte at M=64
    for m in (37, 64):
        ids = np.sort(np.argsort(rng.random((n, SPARSE_SEARCH_K)), axis=1)[:, :m], axis=1)
        pad = np.arange(m) >= rng.integers(0, m + 1, n)[:, None]
        ids[pad] = SPARSE_SEARCH_K
        w = rng.random((n, m))
        w[pad] = 0.0
        compare_member(check, f"m{m}_k{SPARSE_SEARCH_K}_search",
                       torch.as_tensor(ids, dtype=torch.int32, device=dev),
                       torch.as_tensor(w, dtype=torch.float32, device=dev),
                       edges, SPARSE_SEARCH_K)
    out["kernels"] = {"member_lookup": check.parts}
    return out


def _host_graph(csr):
    """The host Graph of a DeviceCSR."""
    from bigclam_tpu_torch.graph.csr import Graph

    return Graph(csr.indptr.cpu().numpy(), csr.indices.cpu().numpy(),
                 np.arange(csr.num_nodes))


def phase_sparse_main(g, path):
    torch.cuda.reset_peak_memory_stats()
    out, res, counts, state = run_path(
        g, path, FULL["k"],
        ["--max-iters", "5", "--representation", "sparse",
         "--sparse-m", str(SPARSE_M)],
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["llh_history"]
    if out["kernel_path"] != "sparse_merge_pallas" or out["sparse_m"] != SPARSE_M:
        raise AssertionError(f"sparse path ran {out['kernel_path']} M={out['sparse_m']}")
    e = g.num_directed_edges
    want = dict.fromkeys(counts, 0)
    want["member_lookup"] = sparse_launches(e, SPARSE_M, out["steps"])
    want["cand_sweep"] = out["steps"]
    if counts != want or want["member_lookup"] < 1:
        raise AssertionError(f"sparse launches {counts}, want {want}")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (state.F, state.ids, state.sumF))
    return state, counts, {
        "kernel_path": out["kernel_path"],
        "llh_history": hist,
        "steps": out["steps"],
        "iters": out["iters"],
        "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"],
        "launches": counts,
        "peak_device_gb": peak_gb,
        "state_bytes": state_bytes,
        "dense_F_bytes": 4 * g.num_nodes * FULL["k"],
        "n": g.num_nodes, "directed_edges": e, "k": FULL["k"], "m": SPARSE_M,
    }


def phase_sparse_full(g, state):
    """The member kernel vs plain over every edge of sparse_main's final
    state, both timed per sweep, then one step timed and split."""
    from bigclam_tpu_torch.models.sparse import SparseBigClamModel
    from bigclam_tpu_torch.ops import sparse_members as sm

    cfg = sparse_cfg(FULL["k"], SPARSE_M)
    model = SparseBigClamModel(g, cfg, device=DEVICE)
    if model.engaged_path != "sparse_merge_pallas" or model.n_pad != state.F.shape[0]:
        raise AssertionError((model.engaged_path, model.n_pad, tuple(state.F.shape)))
    ids, w, k_pad, edges = state.ids, state.F, model.k_pad, model.edges
    check = Check("member_lookup")
    compare_member(check, "every_edge", ids, w, edges, k_pad)
    cand_check = Check("cand_sweep")

    def sweep(fn):
        def run():
            return [fn(ids, w, s, d, k_pad) for s, d in edges.slices()]
        return run

    times = {"member_lookup": time_pair(sweep(sm.member_lookup_rows),
                                        sweep(sm.member_lookup_rows_plain))}
    times["member_lookup"]["library_ms"] = None
    side_by_side("member_lookup", sweep(sm.member_lookup_rows))
    e, m = g.num_directed_edges, model.m
    bnd = {"member_lookup": member_bound(g.num_nodes, e, m)}

    # the step, and its parts on the step's own inputs (the support update
    # runs every step at support_every = 1)
    med = lambda fn: statistics.median(time_ms(fn))  # noqa: E731
    ids_s, w_s = sm.support_update(ids, w, model.blocks, m, k_pad)
    sumF = sm.sparse_sumF(ids_s, w_s, k_pad)
    grad, node_llh = sm.sparse_grad_llh(ids_s, w_s, sumF, edges, cfg, k_pad)
    cand = sm.sparse_candidates(ids_s, w_s, grad, edges, cfg, k_pad)
    plain_cfg = cfg.replace(sparse_pallas_merge=False)
    cand_check.close("step_inputs", cand,
                     sm.sparse_candidates(ids_s, w_s, grad, edges, plain_cfg, k_pad))
    cand_ms = time_pair(
        lambda: sm.sparse_candidates(ids_s, w_s, grad, edges, cfg, k_pad),
        lambda: sm.sparse_candidates(ids_s, w_s, grad, edges, plain_cfg, k_pad))
    torch.cuda.reset_peak_memory_stats()
    step = {
        "step_ms": med(lambda: model._step(state)),
        "support_ms": med(lambda: sm.support_update(ids, w, model.blocks, m, k_pad)),
        "passes_ms": med(lambda: (
            sm.sparse_grad_llh(ids_s, w_s, sumF, edges, cfg, k_pad),
            sm.sparse_candidates(ids_s, w_s, grad, edges, cfg, k_pad),
        )),
        "armijo_ms": med(lambda: sm.sparse_armijo_update(
            ids_s, w_s, sumF, grad, node_llh, cand, cfg, k_pad)),
        "sumF_ms": med(lambda: sm.sparse_sumF(ids_s, w_s, k_pad)),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile_call(lambda: model._step(state)),
    }
    # the grad pass runs one member-lookup sweep, the candidate pass one
    # candidate-sweep launch
    step["member_kernel_ms"] = times["member_lookup"]["ms"]
    step["cand_kernel_ms"] = cand_ms["ms"]
    step["passes_rest_ms"] = (step["passes_ms"] - step["member_kernel_ms"]
                              - step["cand_kernel_ms"])
    # the step computes sumF twice (before the passes and after Armijo)
    step["other_ms"] = step["step_ms"] - (
        step["support_ms"] + step["passes_ms"] + step["armijo_ms"] + 2 * step["sumF_ms"]
    )
    return {"member_lookup": check, "cand_sweep": cand_check}, times, bnd, {
        "kernels": {"member_lookup": {**check.parts, **times["member_lookup"],
                                      **bnd["member_lookup"]},
                    "cand_sweep": {**cand_check.parts, **cand_ms,
                                   **cand_sweep_bound(g.num_nodes, e, m,
                                                      len(cfg.step_candidates))}},
        "step": step, "m": m, "n_pad": model.n_pad, "block_b": model.block_b,
        "edge_chunk": edges.chunk,
    }


# the benchmark's sparse cell (clambench/configs/yt_k8385_sparse.json):
# com-Youtube's nodes and directed edges, K = 8,385, M = 64, 16 steps
CAND_YT = dict(n=1_134_890, e=5_975_248, k=8_385, m=64, seed=26)


def phase_cand_sweep_yt() -> tuple:
    """The candidate-sweep kernel at the sparse cell's shapes against the
    plain sweep (float32 band) and both timed beside the bound: random
    member rows of K ids (a random fill a row, a gradient of both signs),
    edges in CSR order from uniform sources, swept in the model's chunks
    on the plain path."""
    from bigclam_tpu_torch.ops import sparse_members as sm
    from bigclam_tpu_torch.ops.objective import EdgeChunks, edge_chunk_bound

    c = CAND_YT
    n, e, k, m = c["n"], c["e"], c["k"], c["m"]
    gen = torch.Generator(device=DEVICE).manual_seed(c["seed"])
    ids = torch.randint(0, k, (n, m), generator=gen, device=DEVICE).sort(dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    fill = torch.randint(0, m + 1, (n, 1), generator=gen, device=DEVICE)
    ids[dup | (torch.arange(m, device=DEVICE) >= fill)] = k
    ids = ids.sort(dim=1).values.to(torch.int32).contiguous()
    live = ids < k
    w = torch.rand((n, m), generator=gen, device=DEVICE) * live
    grad = torch.randn((n, m), generator=gen, device=DEVICE) * 0.5 * live
    src = torch.randint(0, n, (e,), generator=gen, device=DEVICE).sort().values
    dst = torch.randint(0, n, (e,), generator=gen, device=DEVICE)
    cfg = sparse_cfg(k, m)
    edges = EdgeChunks(src, dst, edge_chunk_bound(cfg, m, 4))
    plain_cfg = cfg.replace(sparse_pallas_merge=False)
    check = Check("cand_sweep")
    reset_launch_counts()
    got = sm.sparse_candidates(ids, w, grad, edges, cfg, k)
    torch.cuda.synchronize()
    if launch_counts()["cand_sweep"] != 1:
        raise AssertionError(f"launches {launch_counts()}")
    check.close("yt_shapes", got, sm.sparse_candidates(ids, w, grad, edges, plain_cfg, k))
    times = time_pair(lambda: sm.sparse_candidates(ids, w, grad, edges, cfg, k),
                      lambda: sm.sparse_candidates(ids, w, grad, edges, plain_cfg, k))
    times["library_ms"] = None
    bnd = cand_sweep_bound(n, e, m, len(cfg.step_candidates))
    return check, times, bnd, {
        "kernels": {"cand_sweep": {**check.parts, **times, **bnd}},
        "card": CARD.get("nvidia_smi"), **c, "edge_chunk": edges.chunk,
        "live_slots": int(live.sum()), "sources": int(torch.unique(src).numel()),
    }


def llh_rel(a, b) -> float:
    """Largest relative difference of two LLH histories of one length."""
    if len(a) != len(b):
        raise AssertionError(f"histories differ in length: {a} vs {b}")
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def phase_sparse_parity(tmp) -> dict:
    """The sparse path at M=16 (M < K) and M=100 (= K) on the card against
    the CPU float64 sparse path, from one conductance init; at M = K also
    against the card's dense `csr_fused` path."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.models.sparse import SparseBigClamModel

    path = os.path.join(tmp, "sparse_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    k = PARITY["k"]
    kw = dict(max_iters=4, conv_tol=0.0)
    F0 = cli.init_F(g, sparse_cfg(k, k, **kw), "conductance")

    out = {"n": g.num_nodes, "edges": g.num_edges, "k": k}
    for m in SPARSE_PARITY_M:
        cfg = sparse_cfg(k, m, **kw)
        card = SparseBigClamModel(g, cfg, device=DEVICE)
        cpu = SparseBigClamModel(g, cfg.replace(dtype="float64"), device="cpu")
        if (card.engaged_path, cpu.engaged_path) != ("sparse_merge_pallas", "sparse_xla"):
            raise AssertionError((card.engaged_path, cpu.engaged_path))
        reset_launch_counts()
        a = card.fit(F0).llh_history
        launches = launch_counts()["member_lookup"]
        if launches != sparse_launches(g.num_directed_edges, card.m, len(a)):
            raise AssertionError(f"M={m}: {launches} member launches for {len(a)} steps")
        b = cpu.fit(F0).llh_history
        r = llh_rel(a, b)
        if r > LLH_RTOL:
            raise AssertionError(f"M={m}: card LLH {a} vs cpu float64 {b}")
        out[f"m{m}"] = {"gpu_llh": a, "cpu_f64_llh": b, "max_rel": r,
                        "launches": launches}
        if m >= k:
            dense = BigClamModel(g, cfg.replace(representation="dense"), device=DEVICE)
            if dense.engaged_path != "csr_fused":
                raise AssertionError(dense.engaged_path)
            d = dense.fit(F0).llh_history
            r = llh_rel(a, d)
            if r > LLH_RTOL:
                raise AssertionError(f"M=K sparse LLH {a} vs dense csr_fused {d}")
            out[f"m{m}"].update(dense_llh=d, max_rel_vs_dense=r)
    return out


# --- the sparse sharded trainer (parallel/sparse_sharded.py) ----------------

SPARSE_MESH_ODD_DP = 3        # uneven: the odd graph pads to 3 x 136 rows
SPARSE_MESH_ODD_CASES = ((1000, 37), (1000, 64), (1100, 1024))   # (K, M)
SPARSE_MESH_DP = 4            # sparse_mesh_full: --mesh 4,1 on one card
# com-youtube's shape (SNAP: 1,134,890 nodes, K = 8,385 in the reference's
# v3 regime): planted blocks of 135 nodes, 2,915 nodes in none
SPARSE_LOCAL = dict(n=1_134_890, k=8_385, p_in=0.04, seed=19)
SPARSE_LOCAL_DP = 8
SPARSE_LOCAL_STEPS = 5        # steps 0..5 (6 steps run)
# the community-local init's weight: at weight 1 a block's sumF (135) puts
# 8,384 x 135^2 into the off-support part of ||grad||^2, and under the
# dense Armijo rule the sparse step keeps no row takes a step that moves a
# float32 weight (sparse_mesh_local shows it); at 0.05 the ascent moves
SPARSE_LOCAL_W = 0.05
SPARSE_MESH_PARITY_M = 16
SPARSE_MESH_PARITY_CAP = 8    # overflows every step (K = 100, M = 16)


@contextlib.contextmanager
def member_spy(check, tag):
    """Every member-lookup launch the block makes, held against the plain
    version on the same arguments (the gathered rows, the offset source
    ids), bit for bit. Yields the count of checked launches."""
    from bigclam_tpu_torch.ops import sparse_members as sm

    orig = sm.member_lookup_rows
    seen = [0]

    def spy(ids, w, s, d, k_pad):
        got = orig(ids, w, s, d, k_pad)
        check.equal(tag, got, sm.member_lookup_rows_plain(ids, w, s, d, k_pad))
        seen[0] += 1
        return got

    # the wrapper counts its launches on the module's name
    spy.launches = orig.launches
    sm.member_lookup_rows = spy
    try:
        yield seen
    finally:
        sm.member_lookup_rows = orig
        orig.launches = spy.launches


def mesh_member_launches(model, steps: int) -> int:
    """Member-lookup launches of `steps` steps of a sparse mesh: one per
    edge chunk of each shard in the grad/LLH sweep (the candidate sweep is
    one cand_sweep launch a shard and step)."""
    return steps * sum(-(-int(e.src.shape[0]) // e.chunk) for e in model.edges)


def check_allreduce(vals, pres, devices, k_pad) -> dict:
    """The sparse allreduce in its sparse mode (a cap at the worst shard's
    count), its static-psum form and its overflow fallback (cap 8), each
    bit for bit the psum helper's sum, with their counters."""
    from bigclam_tpu_torch.parallel import sparse_collectives as sc
    from bigclam_tpu_torch.parallel.sharded import psum

    ref = psum(vals, devices)[0]
    worst = max(int(p.sum()) for p in pres)
    if worst <= 8:
        raise AssertionError(f"{worst} touched ids: a cap of 8 cannot overflow")
    runs = {
        "sparse": sc.sparse_allreduce_sum(
            vals, pres, min(-(-worst // 8) * 8, k_pad), k_pad, devices),
        "psum": sc.psum_allreduce_sum(vals, pres, devices),
        "overflow": sc.sparse_allreduce_sum(vals, pres, 8, k_pad, devices),
    }
    out = {"touched_max": worst}
    for name, (sums, cnt, fb) in runs.items():
        want_fb = int(name != "sparse")
        if not torch.equal(sums[0], ref) or (int(cnt), int(fb)) != (worst, want_fb):
            raise AssertionError(f"sparse allreduce {name}: count {int(cnt)}, "
                                 f"fallback {int(fb)}, bits equal "
                                 f"{torch.equal(sums[0], ref)}")
        out[name] = {"bit_equal_psum": True, "count": int(cnt), "fallback": int(fb)}
    return out


def random_members(g, k: int, m: int, seed: int) -> np.ndarray:
    """A dense (N, k) init with about m + 5 positive entries a row (the
    top-M cut truncates), weights from uniform(0.001, 0.01): small enough
    that the two steps keep the member lists (from uniform(0.05, 0.5) the
    K = 1,100, M = 1,024 case lost every member)."""
    rng = np.random.default_rng(seed)
    F0 = np.zeros((g.num_nodes, k))
    width = min(m + 5, k)
    cols = np.argsort(rng.random((g.num_nodes, k)), axis=1)[:, :width]
    np.put_along_axis(F0, cols, rng.uniform(0.001, 0.01, cols.shape), axis=1)
    return F0


def phase_sparse_mesh_odd() -> dict:
    """The member kernel through the sweeps of an uneven dp = 3 sparse
    mesh (the lookups read the gathered rows with the shard's source ids
    offset), bit for bit its plain version on every launch of two steps
    (support updates included), on the odd and hub graphs at (K, M) =
    (1000, 37), (1000, 64) and (1100, 1024); then the sparse allreduce of
    the stepped shards' sumF in its three forms against the psum."""
    from bigclam_tpu_torch.ops import sparse_members as sm
    from bigclam_tpu_torch.parallel import SparseShardedBigClamModel

    graphs = {"odd": odd_graph(), "hub": hub_graph()}
    check = Check("member_lookup")
    out = {"card": CARD.get("nvidia_smi"), "dp": SPARSE_MESH_ODD_DP}
    for gname, g in graphs.items():
        for k, m in SPARSE_MESH_ODD_CASES:
            tag = f"{gname}_k{k}_m{m}"
            model = SparseShardedBigClamModel(
                g, sparse_cfg(k, m), repeated_mesh(SPARSE_MESH_ODD_DP))
            if not model.engaged_path.startswith("sparse_merge_pallas_"):
                raise AssertionError(f"{tag}: ran {model.engaged_path}")
            state = model.init_state(random_members(g, k, m, k + m))
            with member_spy(check, tag) as seen:
                for _ in range(2):
                    state = model._step(state)
            torch.cuda.synchronize()
            if seen[0] != mesh_member_launches(model, 2):
                raise AssertionError(f"{tag}: {seen[0]} lookups checked")
            vals = [sm.sparse_sumF(i, w, k) for i, w in zip(state.ids, state.F)]
            pres = [sm.presence(i, k) for i in state.ids]
            out[tag] = {
                "n_pad": model.n_pad, "block_b": model.block_b, "m": model.m,
                "path": model.engaged_path, "lookups_checked": seen[0],
                "shard_edges": [int(e.src.shape[0]) for e in model.edges],
                "allreduce": check_allreduce(vals, pres, model.devices, k),
            }
    out["kernels"] = {"member_lookup": check.parts}
    return check, out


def phase_sparse_mesh_full(g, gi, path, F0, sp_main) -> tuple:
    """`cli fit --mesh 4,1 --representation sparse --sparse-m 64` at full,
    the four positions on one card: the path and its exchange mode,
    member-lookup launches against the schedule, the LLH against
    sparse_main's one-card history, sec_per_iter beside it, peak device
    memory against the fit's model (check_peak), the counted comms bytes
    against the model; one step timed whole and split."""
    from bigclam_tpu_torch.parallel import SparseShardedBigClamModel
    from bigclam_tpu_torch.utils.profiling import step_split

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, _, counts, state = run_path(g, path, FULL["k"], [
        "--max-iters", "5", "--representation", "sparse",
        "--sparse-m", str(SPARSE_M), "--mesh", f"{SPARSE_MESH_DP},1"])
    peak = torch.cuda.max_memory_allocated() - base
    want_path = "sparse_merge_pallas_" + (
        "spall" if out["sparse_comm"] == "sparse" else "psum")
    if (out["kernel_path"], out.get("mesh")) != (want_path, f"{SPARSE_MESH_DP}x1"):
        raise AssertionError(f"ran {out['kernel_path']} on {out.get('mesh')}")
    modeled = out["hbm_modeled_bytes"]
    ratio = check_peak("sparse mesh", peak, modeled, 1)
    model = SparseShardedBigClamModel(gi, sparse_cfg(FULL["k"], SPARSE_M),
                                      repeated_mesh(SPARSE_MESH_DP))
    want = dict.fromkeys(counts, 0)
    want["member_lookup"] = mesh_member_launches(model, out["steps"])
    want["cand_sweep"] = out["steps"] * len(model.edges)
    if counts != want:
        raise AssertionError(f"sparse mesh launches {counts}, want {want}")
    hist = out["llh_history"]
    rel = llh_rel(hist, sp_main["llh_history"])
    if rel > LLH_RTOL:
        raise AssertionError(f"sparse mesh LLH {hist} vs one card "
                             f"{sp_main['llh_history']}")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    model.init_state(F0)                  # the fit's cap refinement
    comms = model.comms_measured(state)
    if comms["counted_sites"] != model.comms.site_bytes():
        raise AssertionError(f"counted {comms['counted_sites']} vs modeled "
                             f"{model.comms.site_bytes()}")
    state = model._step(state)
    whole = statistics.median(time_ms(lambda: model._step(state), 3))
    with step_split() as parts:
        model._step(state)
    return counts, {
        "card": CARD.get("nvidia_smi"), "kernel_path": out["kernel_path"],
        "mesh": out["mesh"], "sparse_comm": out["sparse_comm"],
        "sparse_comm_cap": out["sparse_comm_cap"],
        "path_reason": out["kernel_path_reason"],
        "llh_history": hist, "max_rel_vs_sparse_main": rel,
        "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
        "sparse_main_sec_per_iter": sp_main["sec_per_iter"],
        "launches": counts, "peak_gb_measured": peak / 1e9,
        "peak_gb_modeled": modeled / 1e9, "peak_modeled_over_measured": ratio,
        "comms_bytes_per_step": out.get("comms_bytes_per_step"),
        "comms_counted": comms, "n_pad": model.n_pad, "block_b": model.block_b,
        "shard_edges": [int(e.src.shape[0]) for e in model.edges],
        "step_ms": whole, "split_ms": parts, "stage_seconds": out["stage_seconds"],
    }


def local_state(model, in_blocks: int, size: int, weight: float):
    """The community-local state of sparse_mesh_local: node u < in_blocks
    a member of block u // size only, at `weight`; entered through the
    hooks init_state calls after from_dense."""
    k = model.k_pad
    ids = np.full((model.n_pad, model.m), k, np.int32)
    w = np.zeros((model.n_pad, model.m), np.float32)
    ids[:in_blocks, 0] = np.arange(in_blocks) // size
    w[:in_blocks, 0] = weight
    model._on_init_sparsified(ids)
    return model.reset_state(*model._place(ids, w))


def phase_sparse_mesh_local() -> tuple:
    """The sparse exchange at com-youtube's shape: planted blocks of 135
    nodes at K = 8,385 on --mesh 8,1 of one card, M = 64, a
    community-local init through the hooks init_state calls after
    from_dense (no dense 1,134,890 x 8,385 F0 on the host). The path must
    end in `_spall`, every step exchange fewer than K/2 ids with no
    fallback, and the LLH rise; the cap, the counted comms bytes against
    the model, sec_per_iter, peak device memory beside the dense F's."""
    from bigclam_tpu_torch.models.agm import sample_planted_graph
    from bigclam_tpu_torch.parallel import SparseShardedBigClamModel

    c = SPARSE_LOCAL
    t0 = time.perf_counter()
    g, truth = sample_planted_graph(c["n"], c["k"], p_in=c["p_in"],
                                    rng=np.random.default_rng(c["seed"]))
    sample_s = time.perf_counter() - t0
    size = len(truth[0])
    in_blocks = sum(len(t) for t in truth)
    t0 = time.perf_counter()
    cfg = sparse_cfg(c["k"], SPARSE_M, max_iters=SPARSE_LOCAL_STEPS, conv_tol=0.0)
    model = SparseShardedBigClamModel(g, cfg, repeated_mesh(SPARSE_LOCAL_DP))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = local_state(model, in_blocks, size, SPARSE_LOCAL_W)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    if not model.engaged_path.endswith("_spall"):
        raise AssertionError(f"ran {model.engaged_path} (cap {model.comm_cap})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    hist, comm = [], []
    t0 = time.perf_counter()
    for _ in range(SPARSE_LOCAL_STEPS + 1):
        state = model._step(state)
        hist.append(float(state.llh))
        comm.append(model.last_comm(state))
    loop_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    if any(fb or ex >= c["k"] / 2 for ex, fb in comm):
        raise AssertionError(f"exchanges {comm} (K = {c['k']})")
    want = dict.fromkeys(counts, 0)
    want["member_lookup"] = mesh_member_launches(model, len(hist))
    want["cand_sweep"] = len(hist) * len(model.edges)
    if counts != want:
        raise AssertionError(f"sparse mesh launches {counts}, want {want}")
    if not (all(math.isfinite(v) for v in hist) and hist[-1] > hist[0]):
        raise AssertionError(f"LLH history {hist}")
    comms = model.comms_measured(state)
    if comms["counted_sites"] != model.comms.site_bytes():
        raise AssertionError(f"counted {comms['counted_sites']} vs modeled "
                             f"{model.comms.site_bytes()}")
    # the same blocks at weight 1: the LLH does not move (the histogram of
    # accepted steps shows the largest step each row takes)
    del state
    state = local_state(model, in_blocks, size, 1.0)
    at_one = []
    for _ in range(2):
        state = model._step(state)
        at_one.append({"llh": float(state.llh),
                       "accept_hist": state.accept_hist.tolist()})
    del state
    return counts, {
        "card": CARD.get("nvidia_smi"), "n": g.num_nodes,
        "undirected_edges": g.num_edges, "blocks": len(truth),
        "block_size": size, "nodes_in_no_block": g.num_nodes - in_blocks,
        "k": c["k"], "m": model.m, "dp": SPARSE_LOCAL_DP, "init_weight": SPARSE_LOCAL_W,
        "kernel_path": model.engaged_path, "comm_cap": model.comm_cap,
        "comm_mode": model.comm_mode, "path_reason": model.path_reason,
        "exchanged_ids_by_step": [ex for ex, _ in comm],
        "llh_history": hist, "sec_per_iter": loop_s / len(hist),
        "at_weight_1": at_one,
        "launches": counts, "comms_bytes_per_step_modeled": model.comms.bytes_per_step(),
        "comms_counted": comms, "peak_gb_measured": peak / 1e9,
        "peak_gb_modeled": model.memory.hbm_bytes() / 1e9,
        "dense_F_gb": 4 * g.num_nodes * c["k"] / 1e9,
        "sample_s": sample_s, "model_build_s": build_s, "upload_s": upload_s,
        "n_pad": model.n_pad, "block_b": model.block_b,
    }


def phase_sparse_mesh_parity(tmp) -> dict:
    """The parity graph on a (4, 1) sparse mesh of the card against the
    CPU float64 sharded fit (LLH within 1e-4); a cap of 8 that overflows
    every step (comm_dense 1, every allreduce bit for bit the psum of its
    inputs) beside the psum build; a checkpoint's restored state bit for
    bit the saved one, and the resumed history against the uninterrupted
    fit (the card's index_add_ order varies between runs: two
    uninterrupted fits are set beside it)."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.parallel import SparseShardedBigClamModel, make_mesh
    from bigclam_tpu_torch.parallel import sparse_sharded as ss
    from bigclam_tpu_torch.parallel.sharded import psum
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    path = os.path.join(tmp, "sparse_mesh_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    k, m = PARITY["k"], SPARSE_MESH_PARITY_M
    cfg = sparse_cfg(k, m, max_iters=4, conv_tol=0.0)
    F0 = cli.init_F(g, sparse_cfg(k, k), "conductance")
    mesh = repeated_mesh(SPARSE_MESH_DP)
    card = SparseShardedBigClamModel(g, cfg, mesh)
    cpu = SparseShardedBigClamModel(
        g, cfg.replace(dtype="float64"),
        make_mesh((SPARSE_MESH_DP, 1), [torch.device("cpu")] * SPARSE_MESH_DP))
    reset_launch_counts()
    a = card.fit(F0).llh_history
    launches = launch_counts()["member_lookup"]
    if launches != mesh_member_launches(card, len(a)):
        raise AssertionError(f"{launches} member launches for {len(a)} steps")
    b = cpu.fit(F0).llh_history
    if (card.engaged_path[:20], cpu.engaged_path[:11]) != (
            "sparse_merge_pallas_", "sparse_xla_"):
        raise AssertionError((card.engaged_path, cpu.engaged_path))
    rel = llh_rel(a, b)
    if rel > LLH_RTOL:
        raise AssertionError(f"card LLH {a} vs cpu float64 {b}")
    out = {"card": CARD.get("nvidia_smi"), "n": g.num_nodes, "k": k, "m": m,
           "path": card.engaged_path, "comm_cap": card.comm_cap,
           "gpu_llh": a, "cpu_f64_llh": b, "max_rel": rel, "launches": launches}

    # the overflow build: every allreduce falls back, bit for bit the psum
    over = SparseShardedBigClamModel(
        g, cfg.replace(sparse_comm_cap=SPARSE_MESH_PARITY_CAP), mesh)
    orig = ss.sparse_allreduce_sum
    calls = []

    def spy(vals, pres, cap, k_pad, devices):
        sums, cnt, fb = orig(vals, pres, cap, k_pad, devices)
        calls.append((int(fb), torch.equal(sums[0], psum(vals, devices)[0])))
        return sums, cnt, fb

    ss.sparse_allreduce_sum = spy
    try:
        state = over.init_state(F0)
        hist_over, flags = [], []
        for _ in range(5):
            state = over._step(state)
            hist_over.append(float(state.llh))
            flags.append(over.last_comm(state))
    finally:
        ss.sparse_allreduce_sum = orig
    if (over.comm_cap, over.comm_mode) != (SPARSE_MESH_PARITY_CAP, "sparse") or \
            not all(fb for _, fb in flags) or calls != [(1, True)] * 10:
        raise AssertionError(f"overflow build: cap {over.comm_cap} "
                             f"{over.comm_mode}, counters {flags}, calls {calls}")
    ps = SparseShardedBigClamModel(g, cfg.replace(sparse_dense_fallback=0.0), mesh)
    hist_psum = [ps.fit(F0).llh_history for _ in range(2)]
    out["overflow"] = {
        "comm_cap": over.comm_cap, "counters": flags, "allreduces_checked": len(calls),
        "llh": hist_over, "psum_llh": hist_psum[0],
        "vs_psum": history_match(hist_over, hist_psum[0], SPARSE_RESUME_RTOL),
        "two_psum_fits_bit_identical": list(hist_psum[0]) == list(hist_psum[1]),
    }

    # resume: the restored state is the saved one, bit for bit
    cm = CheckpointManager(os.path.join(tmp, "sparse_mesh_ck"))
    SparseShardedBigClamModel(g, cfg.replace(max_iters=2, checkpoint_every=2),
                              mesh).fit(F0, checkpoints=cm)
    step, saved, _ = cm.restore()
    restored, _ = card._restore(cm)
    back = card._state_to_arrays(restored)
    same = {key: bool(np.array_equal(back[key], saved[key]))
            for key in ("F", "ids", "llh", "it")}
    if not all(same.values()) or step != 2:
        raise AssertionError(f"restored state vs saved: {same} (step {step})")
    resumed = card.fit(F0, checkpoints=cm).llh_history
    again = card.fit(F0).llh_history
    out["resume"] = {"resumed_from": step, "restored_bit_for_bit": same,
                     **history_match(resumed, a, SPARSE_RESUME_RTOL),
                     "two_fits_bit_identical": list(a) == list(again),
                     "two_fits_max_rel": llh_rel(list(a), list(again))}
    return out


def compare_edge_terms(check, what, F, grad, edges, cfg):
    """The candidate edge-terms kernel against its plain version on every
    edge chunk (with the chunks' cached runs where `edges` has them, else
    the runs the wrapper computes)."""
    from bigclam_tpu_torch.ops import edge_kernels as ek

    runs = edges.runs or [None] * len(list(edges.slices()))
    for (s, d), r in zip(edges.slices(), runs):
        got = ek.candidate_edge_terms(F, grad, s, d, cfg, r)
        want = ek.candidate_edge_terms_plain(
            F.index_select(0, s), grad.index_select(0, s), F.index_select(0, d),
            None, cfg,
        )
        torch.cuda.synchronize()
        check.close(what, got, want)


def phase_vmem_odd() -> dict:
    """The edge-terms kernel vs plain on the odd graph (isolated nodes, an
    all-zero row) at K=37 and K=1,100, in chunks of 1,000 edges; then on
    the hub graph at K=37 and 1,000 in chunks of 500 edges with their runs
    cached (the degree-700 hub split across two chunks and over many
    32-edge tiles) and with every chunk's edges shuffled (runs of about
    one edge, computed by the wrapper)."""
    from bigclam_tpu_torch.ops.edge_kernels import with_runs
    from bigclam_tpu_torch.ops.objective import EdgeChunks, grad_llh

    check = Check("candidate_edge_terms")
    out = {}
    for k in VMEM_ODD_K:
        F, csr, cfg = odd_case(k)
        edges = EdgeChunks(csr.src, csr.dst, VMEM_ODD_CHUNK)
        grad, _ = grad_llh(F, F.sum(dim=0), edges, cfg)
        compare_edge_terms(check, f"k{k}", F, grad, edges, cfg)
        out[f"k{k}"] = {"n": int(F.shape[0]), "directed_edges": csr.num_directed_edges,
                        "chunk": VMEM_ODD_CHUNK}
    g = hub_graph()
    for k in VMEM_HUB_K:
        F, csr, cfg = odd_case(k, g)
        edges = with_runs(EdgeChunks(csr.src, csr.dst, VMEM_HUB_CHUNK))
        grad, _ = grad_llh(F, F.sum(dim=0), edges, cfg)
        compare_edge_terms(check, f"hub_k{k}", F, grad, edges, cfg)
        perm = torch.as_tensor(
            np.random.default_rng(k).permutation(csr.num_directed_edges), device=F.device)
        shuffled = EdgeChunks(csr.src[perm], csr.dst[perm], VMEM_HUB_CHUNK)
        compare_edge_terms(check, f"hub_shuffled_k{k}", F, grad, shuffled, cfg)
        hub_chunks = [int((s[r[:-1]] == 1).sum()) for (s, _), r in
                      zip(edges.slices(), edges.runs)]
        if sum(hub_chunks) < 2:
            raise AssertionError(f"the hub is not split across chunks: {hub_chunks}")
        out[f"hub_k{k}"] = {
            "n": g.num_nodes, "directed_edges": csr.num_directed_edges,
            "chunk": VMEM_HUB_CHUNK, "hub_degree": int(g.degrees[1]),
            "runs": [int(r.shape[0]) - 1 for r in edges.runs],
            "shuffled_runs": [int(r.shape[0]) - 1 for r in with_runs(shuffled).runs],
        }
    out["kernels"] = {"candidate_edge_terms": check.parts}
    return out


def vmem_launches(e: int, k: int, steps: int) -> int:
    """Candidate edge-terms launches of `steps` pallas_vmem steps: one per
    edge chunk (the plain sweeps' chunking at K columns)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.ops.objective import edge_chunk_bound

    chunk = edge_chunk_bound(BigClamConfig(num_communities=k), k, 4)
    return -(-e // chunk) * steps


def phase_vmem_main(g, path, main_hist):
    torch.cuda.reset_peak_memory_stats()
    out, res, counts, _ = run_path(
        g, path, FULL["k"], ["--max-iters", "5", "--csr-kernels", "off"]
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["llh_history"]
    if out["kernel_path"] != "pallas_vmem":
        raise AssertionError(f"--csr-kernels off ran {out['kernel_path']}")
    e = g.num_directed_edges
    want = dict.fromkeys(counts, 0)
    want["candidate_edge_terms"] = vmem_launches(e, FULL["k"], out["steps"])
    want["armijo_tail_select"] = out["steps"]
    if counts != want or want["candidate_edge_terms"] < 1:
        raise AssertionError(f"pallas_vmem launches {counts}, want {want}")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    rel = llh_rel(hist, main_hist)
    if rel > LLH_RTOL:
        raise AssertionError(f"pallas_vmem LLH {hist} vs csr_fused {main_hist}")
    return res, counts, {
        "kernel_path": out["kernel_path"],
        "kernel_path_reason": out["kernel_path_reason"],
        "llh_history": hist,
        "max_rel_vs_csr_fused": rel,
        "steps": out["steps"],
        "iters": out["iters"],
        "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"],
        "launches": counts,
        "peak_device_gb": peak_gb,
        "n": g.num_nodes, "directed_edges": e, "k": FULL["k"],
    }


def phase_vmem_full(g, F_host):
    """The edge-terms kernel vs plain over every chunk of vmem_main's final
    F, both timed per sweep; the node pass's epilogue (armijo_tail_select)
    vs plain on the step's own inputs, timed beside torch armijo_update; one
    pallas_vmem step timed and split, and one xla step on the same
    state."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.ops import edge_kernels as ek
    from bigclam_tpu_torch.ops import linesearch as ls
    from bigclam_tpu_torch.ops.linesearch import armijo_update, candidates_scan
    from bigclam_tpu_torch.ops.objective import grad_llh

    cfg = BigClamConfig(num_communities=FULL["k"], use_pallas_csr=False)
    model = BigClamModel(g, cfg, device=DEVICE)
    if model.engaged_path != "pallas_vmem":
        raise AssertionError(model.engaged_path)
    state = model.init_state(F_host)
    F, sumF, edges = state.F, state.sumF, model.edges
    grad, node_llh = grad_llh(F, sumF, edges, cfg)
    check = Check("candidate_edge_terms")
    compare_edge_terms(check, "every_chunk", F, grad, edges, cfg)

    if edges.runs is None:
        raise AssertionError("pallas_vmem's edge chunks carry no runs")

    def sweep(fn):
        def run():
            for (s, d), r in zip(edges.slices(), edges.runs):
                fn(s, d, r)
        return run

    times = {"candidate_edge_terms": time_pair(
        sweep(lambda s, d, r: ek.candidate_edge_terms(F, grad, s, d, cfg, r)),
        sweep(lambda s, d, r: ek.candidate_edge_terms_plain(
            F.index_select(0, s), grad.index_select(0, s), F.index_select(0, d),
            None, cfg)),
        reps=2,
    )}
    times["candidate_edge_terms"]["library_ms"] = None
    side_by_side("candidate_edge_terms", lambda: [
        ek.candidate_edge_terms(F, grad, s, d, cfg, r)
        for (s, d), r in zip(edges.slices(), edges.runs)])
    n, k = F.shape
    e, num_s = g.num_directed_edges, len(cfg.step_candidates)
    bnd = {"candidate_edge_terms": edge_terms_bound(n, e, k, num_s)}

    # the step and its parts on the step's own inputs
    med = lambda fn, reps=5: statistics.median(time_ms(fn, reps))  # noqa: E731
    terms = [ek.candidate_edge_terms(F, grad, s, d, cfg, r)
             for (s, d), r in zip(edges.slices(), edges.runs)]

    def sums_only():
        it = iter(terms)
        return candidates_scan(F, edges, cfg, lambda s, d: next(it))

    cand = sums_only()
    select_check = Check("armijo_tail_select")
    check_epilogue(select_check, "vmem", F, sumF, grad, node_llh, cand, cfg)
    times["armijo_tail_select"] = time_pair(
        lambda: ls.armijo_tail_select(F, sumF, grad, node_llh, cand, cfg),
        lambda: ls.armijo_tail_select_plain(F, sumF, grad, node_llh, cand, cfg),
        reps=2)
    times["armijo_tail_select"]["library_ms"] = None
    side_by_side("armijo_tail_select",
                 lambda: ls.armijo_tail_select(F, sumF, grad, node_llh, cand, cfg))
    torch.cuda.reset_peak_memory_stats()
    step = {
        "step_ms": med(lambda: model._step(state)),
        "grad_pass_ms": med(lambda: grad_llh(F, sumF, edges, cfg)),
        "kernel_ms": times["candidate_edge_terms"]["ms"],
        "index_add_ms": med(sums_only),
        # the step's route: the epilogue kernel, the column sums and the
        # histogram in torch
        "armijo_ms": med(lambda: ls.armijo_update_kernel(F, sumF, grad, node_llh, cand,
                                                         cfg, with_stats=True)),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": profile_call(lambda: model._step(state)),
    }
    # the route it replaced, outside the peak
    step["torch_armijo_update_ms"] = med(
        lambda: armijo_update(F, sumF, grad, node_llh, cand, cfg, with_stats=True), 3)
    times["armijo_tail_select"]["torch_armijo_update_ms"] = step["torch_armijo_update_ms"]
    del terms
    step["other_ms"] = step["step_ms"] - (
        step["grad_pass_ms"] + step["kernel_ms"] + step["index_add_ms"] + step["armijo_ms"]
    )
    xla = BigClamModel(g, cfg.replace(use_pallas=False), device=DEVICE)
    if xla.engaged_path != "xla":
        raise AssertionError(xla.engaged_path)
    step["xla_step_ms"] = med(lambda: xla._step(state), reps=2)
    bnd["armijo_tail_select"] = select_bound(n, k, num_s)
    checks = {"candidate_edge_terms": check, "armijo_tail_select": select_check}
    return checks, times, bnd, {
        "kernels": {name: {**checks[name].parts, **times[name], **bnd[name]}
                    for name in checks},
        "step": step, "edge_chunk": edges.chunk,
        "chunks": -(-e // edges.chunk), "k_pad": int(k),
        "runs": sum(int(r.shape[0]) - 1 for r in edges.runs),
    }


def sweep_args(path, grid, extra):
    from bigclam_tpu_torch import cli

    return cli.build_parser().parse_args([
        "sweep", "--graph", path, "--min-com", str(grid["min_com"]),
        "--max-com", str(grid["max_com"]), "--div-com", str(grid["div_com"]),
        "--max-iters", "5", *extra,
    ])


def run_sweep(path, grid, extra):
    """`cli sweep` with the launch counters zeroed just before it; returns
    (JSON, launch counts, [(k, seconds since the previous K ended)])."""
    from bigclam_tpu_torch import cli

    ends = [time.perf_counter()]
    ks = []

    def on_k(k, llh):
        ks.append(k)
        ends.append(time.perf_counter())

    reset_launch_counts()
    out = cli.sweep(sweep_args(path, grid, extra), callback=on_k)
    counts = launch_counts()
    if list(out["llh_by_k"]) != [str(k) for k in ks]:
        raise AssertionError(f"callback Ks {ks} vs {list(out['llh_by_k'])}")
    if not all(math.isfinite(v) for v in out["llh_by_k"].values()):
        raise AssertionError(f"non-finite LLH in {out['llh_by_k']}")
    if str(out["chosen_k"]) not in out["llh_by_k"]:
        raise AssertionError(f"chosen K {out['chosen_k']} was not trained")
    return out, counts, [(k, b - a) for k, a, b in zip(ks, ends, ends[1:])]


def phase_sweep_main(g, path) -> dict:
    out, counts, sec = run_sweep(path, SWEEP_MAIN, ["--device", DEVICE])
    trained = len(out["llh_by_k"])
    if out["kset"] != SWEEP_MAIN["kset"]:
        raise AssertionError(f"grid {out['kset']}, want {SWEEP_MAIN['kset']}")
    if trained < 2:
        raise AssertionError(f"only {trained} K trained: {out['llh_by_k']}")
    if (out["n"], out["edges"]) != (g.num_nodes, g.num_edges):
        raise AssertionError(f"sweep read {out['n']} nodes / {out['edges']} edges")
    # csr_fused at k_pad 1,024: one fused launch per step, at most
    # max_iters + 1 steps per K, nothing else
    fused = counts["fused_superstep"]
    others = {n: c for n, c in counts.items() if n != "fused_superstep" and c}
    if not trained <= fused <= 6 * trained or others:
        raise AssertionError(f"sweep launches {counts} for {trained} Ks")
    return {**out, "trained": trained, "launches": counts,
            "seconds_by_k": {str(k): t for k, t in sec},
            "seconds_first_k_includes": "graph load, conductance seeding, model build"}


def phase_vmem_parity(tmp) -> dict:
    """pallas_vmem on the card against the CPU float64 `xla` path, from
    one conductance init."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    path = os.path.join(tmp, "vmem_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    cfg = BigClamConfig(num_communities=PARITY["k"], max_iters=4, conv_tol=0.0,
                        use_pallas_csr=False)
    F0 = cli.init_F(g, cfg, "conductance")
    card = BigClamModel(g, cfg, device=DEVICE)
    cpu = BigClamModel(g, cfg.replace(dtype="float64"), device="cpu")
    if (card.engaged_path, cpu.engaged_path) != ("pallas_vmem", "xla"):
        raise AssertionError((card.engaged_path, cpu.engaged_path))
    reset_launch_counts()
    a = card.fit(F0).llh_history
    counts = launch_counts()
    launches = counts["candidate_edge_terms"]
    if launches != vmem_launches(g.num_directed_edges, PARITY["k"], len(a)):
        raise AssertionError(f"{launches} edge-terms launches for {len(a)} steps")
    if counts["armijo_tail_select"] != len(a):
        raise AssertionError(f"{counts['armijo_tail_select']} epilogue launches for "
                             f"{len(a)} steps")
    b = cpu.fit(F0).llh_history
    rel = llh_rel(a, b)
    if rel > LLH_RTOL:
        raise AssertionError(f"pallas_vmem card LLH {a} vs cpu float64 {b}")
    return {"gpu_llh": a, "cpu_f64_llh": b, "max_rel": rel, "launches": launches,
            "n": g.num_nodes, "edges": g.num_edges, "k": PARITY["k"]}


def phase_sweep_parity(tmp) -> dict:
    """`cli sweep` on the card against `--device cpu --dtype float64`."""
    path = os.path.join(tmp, "sweep_parity_graph.txt")
    planted_file(PARITY, path)
    gpu, counts, _ = run_sweep(path, SWEEP_PARITY, ["--device", DEVICE])
    cpu, _, _ = run_sweep(path, SWEEP_PARITY, ["--device", "cpu", "--dtype", "float64"])
    if gpu["kset"] != cpu["kset"]:
        raise AssertionError(f"grids differ: {gpu['kset']} vs {cpu['kset']}")
    common = [k for k in gpu["llh_by_k"] if k in cpu["llh_by_k"]]
    if not common:
        raise AssertionError("no K trained on both devices")
    rel = max(abs(gpu["llh_by_k"][k] - cpu["llh_by_k"][k]) / abs(cpu["llh_by_k"][k])
              for k in common)
    if rel > LLH_RTOL:
        raise AssertionError(f"card {gpu['llh_by_k']} vs cpu float64 {cpu['llh_by_k']}")
    # the stop ratios (1 - LLH_K / LLH_Kold) of the CPU run
    llh = [cpu["llh_by_k"][str(k)] for k in cpu["kset"] if str(k) in cpu["llh_by_k"]]
    ratios = [1.0 - b / a for a, b in zip(llh, llh[1:])]
    tol = 1e-3                                  # cli sweep's --ksweep-tol default
    near_tie = any(abs(r - tol) <= 1e-4 for r in ratios)
    if gpu["chosen_k"] != cpu["chosen_k"] and not near_tie:
        raise AssertionError(f"chosen K {gpu['chosen_k']} vs cpu {cpu['chosen_k']}")
    return {"kset": gpu["kset"], "gpu_llh_by_k": gpu["llh_by_k"],
            "cpu_f64_llh_by_k": cpu["llh_by_k"], "max_rel": rel,
            "chosen_k": [gpu["chosen_k"], cpu["chosen_k"]], "stop_ratios": ratios,
            "launches": counts}


# --- the mesh phases: the ring and all-gather schedules -----------------------


def repeated_mesh(dp: int):
    """A dp-shard mesh on one card (the device repeated)."""
    from bigclam_tpu_torch.parallel import make_mesh

    return make_mesh((dp, 1), [torch.device(DEVICE)] * dp)


def ring_fold(model, F, gn, ln):
    """The ring's fold after rotation 1: (sumF per shard, grad, node_llh)."""
    from bigclam_tpu_torch.ops.objective import node_tail
    from bigclam_tpu_torch.parallel.sharded import psum

    sumF = psum([f.sum(dim=0) for f in F], model.devices)
    grad = [g - s[None, :] + f for g, s, f in zip(gn, sumF, F)]
    node_llh = [l + node_tail(f, s) for l, f, s in zip(ln, F, sumF)]
    return sumF, grad, node_llh


def ring_sweep(fn, model, F, acc, *, grad=None):
    """One rotation of kernel #8 (grad None: acc = (gn, ln)) or #9 (acc =
    cb) over every (shard, phase) bucket of `model` on a repeated-device
    mesh, where shard i's phase-r rotating shard is F[(i + r) % dp]."""
    dp = len(F)
    for r in range(dp):
        for i in range(dp):
            rot = F[(i + r) % dp]
            if grad is None:
                fn(F[i], rot, model.buckets[i][r], acc[0][i], acc[1][i], model.cfg)
            else:
                fn(F[i], grad[i], rot, model.buckets[i][r], acc[i], model.cfg)
    return acc


def grad_accs(F):
    return [torch.zeros_like(f) for f in F], [f.new_zeros(f.shape[0]) for f in F]


def cand_accs(F, s):
    return [f.new_zeros((s, f.shape[0])) for f in F]


def compare_ring_kernels(checks, model, F, grad, cfg, tag):
    """Kernels #8 and #9 against their plain versions over every (shard,
    phase) bucket of `model`'s layout, on F shards `F` (any K), each
    accumulating across the phases from the same random accumulators;
    compared after every phase."""
    from bigclam_tpu_torch.ops import ring_kernels as rk

    dp, s = len(F), len(cfg.step_candidates)
    torch.manual_seed(0)
    for i in range(dp):
        n, k = F[i].shape
        dev = F[i].device
        acc0 = (torch.rand((n, k), device=dev), torch.rand(n, device=dev),
                torch.rand((s, n), device=dev))
        kern = [a.clone() for a in acc0]
        plain = [a.clone() for a in acc0]
        for r in range(dp):
            rot, b = F[(i + r) % dp], model.buckets[i][r]
            rk.ring_grad_phase(F[i], rot, b, kern[0], kern[1], cfg)
            rk.ring_grad_phase_plain(F[i], rot, b, plain[0], plain[1], cfg)
            rk.ring_cand_phase(F[i], grad[i], rot, b, kern[2], cfg)
            rk.ring_cand_phase_plain(F[i], grad[i], rot, b, plain[2], cfg)
            torch.cuda.synchronize()
            checks["ring_grad_phase"].close(f"{tag}_gn", kern[0], plain[0])
            checks["ring_grad_phase"].close(f"{tag}_ln", kern[1], plain[1])
            checks["ring_cand_phase"].close(f"{tag}_cb", kern[2], plain[2])


def bucket_edges(model) -> list:
    return [[b.num_directed_edges for b in row] for row in model.buckets]


def visit_orders_agree(model, F) -> dict:
    """Kernel #8's rotation under every visit order against the identity
    order, bit for bit (the order decides which warps run together, never
    a node's sum); leaves the model's own order in place. Returns
    {order: rows visited}."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.parallel.ring import VISIT_ORDERS

    chosen = model.visit_order
    want, rows = None, {}
    for how in ("identity", *[h for h in VISIT_ORDERS if h != "identity"]):
        model.set_visit_order(how)
        gn, ln = ring_sweep(rk.ring_grad_phase, model, F, grad_accs(F))
        torch.cuda.synchronize()
        got = gn + ln
        if want is None:
            want = got
        elif not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"kernel #8 under visit order {how} differs from "
                                 "the identity order")
        rows[how] = sum(int(b.order.shape[0]) for row in model.buckets for b in row)
    model.set_visit_order(chosen)
    return rows


def visit_order_ms(model, F) -> dict:
    """Median CUDA-event time of one kernel #8 sweep under each visit order
    (2 x 5 runs each, in the order of VISIT_ORDERS and then reversed);
    leaves the model's own order in place."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.parallel.ring import VISIT_ORDERS

    chosen, acc = model.visit_order, grad_accs(F)
    runs = {how: [] for how in VISIT_ORDERS}
    for seq in (VISIT_ORDERS, VISIT_ORDERS[::-1]):
        for how in seq:
            model.set_visit_order(how)
            runs[how] += time_ms(lambda: ring_sweep(rk.ring_grad_phase, model, F, acc))
    model.set_visit_order(chosen)
    return {how: statistics.median(t) for how, t in runs.items()}


def phase_ring_odd():
    """#8 and #9 vs plain on the odd graph at dp = 3 on a repeated-device
    mesh: n_pad 405 (odd), shard 0's phase-2 bucket empty (the planted
    blocks never reach shard 2 from shard 0), an all-zero row, at K = 37
    (unpadded) and K = 1,024; then the hub graph at K = 37, 1,000, 1,024.
    Every case also runs #8 under each visit order, bit-equal to the
    identity order, and the node pass's epilogue of every shard against
    plain (ring_epilogues)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import RingBigClamModel

    def run(g, k, tag):
        # random F (row 7 zero) and grad at K on g's dp = 3 layout, every
        # bucket of both kernels against plain
        cfg = BigClamConfig(num_communities=k)
        model = RingBigClamModel(g, cfg, repeated_mesh(RING_ODD_DP), balance=False)
        rng = np.random.default_rng(k)
        rows = model.n_pad // RING_ODD_DP
        F = np.zeros((model.n_pad, k))
        F[: g.num_nodes] = rng.uniform(0.0, 1.0, (g.num_nodes, k))
        F[7] = 0.0
        G = rng.uniform(-1.5, 1.5, (model.n_pad, k))
        shard = lambda M, i: torch.as_tensor(  # noqa: E731
            M[i * rows : (i + 1) * rows], dtype=torch.float32, device=DEVICE)
        shards = [shard(F, i) for i in range(RING_ODD_DP)]
        compare_ring_kernels(
            checks, model, shards, [shard(G, i) for i in range(RING_ODD_DP)], cfg, tag,
        )
        ring_epilogues(checks["armijo_tail_select"], tag, model, shards)
        out[tag] = {"n_pad": model.n_pad, "bucket_edges": bucket_edges(model),
                    "visit_order_rows": visit_orders_agree(model, shards)}
        return out[tag]

    checks = {n: Check(n) for n in (*RING, "armijo_tail_select")}
    out = {"dp": RING_ODD_DP}
    g = odd_graph()
    for k in RING_ODD_K:
        layout = run(g, k, f"k{k}")
        sizes = layout["bucket_edges"]
        if min(map(min, sizes)) != 0 or layout["n_pad"] % 2 == 0:
            raise AssertionError(f"want an empty bucket and odd n_pad: {sizes}")
    g = hub_graph()
    for k in HUB_K:
        run(g, k, f"hub_k{k}")
    return checks, {**out, "kernels": {n: c.parts for n, c in checks.items()}}


def mesh_init(path):
    """The ingested full graph and its conductance F0 (float64, host): the
    in-process mesh phases start where `main` started."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph

    g = build_graph(path)
    return g, cli.init_F(g, BigClamConfig(num_communities=FULL["k"]), "conductance")


def ring_launches_want(counts, dp: int, steps: int) -> dict:
    """Per step each ring kernel once per (shard, phase) bucket and the
    node pass's epilogue once per shard."""
    want = dict.fromkeys(counts, 0)
    want.update(ring_grad_phase=dp * dp * steps, ring_cand_phase=dp * dp * steps,
                armijo_tail_select=dp * steps)
    return want


def phase_ring_main(g, path, main_hist):
    torch.cuda.reset_peak_memory_stats()
    out, _, counts, _ = run_path(
        g, path, FULL["k"],
        ["--max-iters", "5", "--mesh", "1,1", "--schedule", "ring"],
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = out["llh_history"]
    if (out["kernel_path"], out.get("mesh")) != ("csr_ring_fused", "1x1"):
        raise AssertionError(f"ring ran {out['kernel_path']} on {out.get('mesh')}")
    want = ring_launches_want(counts, 1, out["steps"])
    if counts != want:
        raise AssertionError(f"csr_ring_fused launches {counts}, want {want}")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    rel = llh_rel(hist, main_hist)
    if rel > LLH_RTOL:
        raise AssertionError(f"ring LLH {hist} vs csr_fused {main_hist}")
    e = g.num_directed_edges
    return counts, {
        "kernel_path": out["kernel_path"], "mesh": out["mesh"],
        "llh_history": hist, "max_rel_vs_csr_fused": rel,
        "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"], "launches": counts,
        "peak_device_gb": peak_gb,
    }


def fit_mesh(model, F0, want_path, main_hist, counts_want):
    """model.fit_state from F0 with the launch counters zeroed just before
    and read just after; checks the path, launches and LLH against main's
    history. Returns (final state, body)."""
    if model.engaged_path != want_path:
        raise AssertionError(f"ran {model.engaged_path}, want {want_path}")
    state0 = model.init_state(F0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, _, _, hist = model.fit_state(state0)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = counts_want(counts, len(hist))
    if counts != want:
        raise AssertionError(f"{want_path} launches {counts}, want {want}")
    rel = llh_rel(list(hist), main_hist[: len(hist)])
    if rel > LLH_RTOL:
        raise AssertionError(f"{want_path} LLH {hist} vs csr_fused {main_hist}")
    return state, {
        "kernel_path": want_path, "llh_history": list(hist),
        "max_rel_vs_csr_fused": rel, "steps": len(hist),
        "sec_per_iter": wall / len(hist), "launches": counts,
    }


def ring_epilogues(check, tag, model, F):
    """The node pass's epilogue (armijo_tail_select) of every shard against
    plain, on the inputs a ring step gives it: the fold of the plain #8
    sweep and the plain #9 sweep's neighbour sums."""
    from bigclam_tpu_torch.ops import ring_kernels as rk

    gn, ln = ring_sweep(rk.ring_grad_phase_plain, model, F, grad_accs(F))
    sumF, grad, node_llh = ring_fold(model, F, gn, ln)
    cb = ring_sweep(rk.ring_cand_phase_plain, model, F,
                    cand_accs(F, len(model.cfg.step_candidates)), grad=grad)
    for i in range(len(F)):
        check_epilogue(check, f"{tag}_shard{i}", F[i], sumF[i], grad[i], node_llh[i],
                       cb[i], model.cfg)
    return sumF, grad, node_llh, cb


def ring_step_split(model, state) -> dict:
    """One csr_ring_fused step on `state`, whole and in parts: rotation 1
    (kernel #8, fresh accumulators), the fold and node tail, rotation 2
    (kernel #9), the Armijo tails and selection of every shard, and the
    psums (column sums, LLH, histogram)."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.parallel.sharded import armijo_tail_select_sharded, psum

    F, cfg, devices = state.F, model.cfg, model.devices
    s = len(cfg.step_candidates)
    med = lambda fn: statistics.median(time_ms(fn, 3))  # noqa: E731
    gn, ln = ring_sweep(rk.ring_grad_phase, model, F, grad_accs(F))
    sumF, grad, node_llh = ring_fold(model, F, gn, ln)
    cb = ring_sweep(rk.ring_cand_phase, model, F, cand_accs(F, s), grad=grad)
    outs = [
        armijo_tail_select_sharded(F[i], grad[i], node_llh[i], cb[i], sumF[i], cfg,
                                   kernel=True)
        for i in range(len(F))
    ]

    def psums():
        psum([f.sum(dim=0) for f in F], devices)
        psum([o[1] for o in outs], devices)
        psum([nl.sum() for nl in node_llh], devices)
        psum([o[2] for o in outs], devices)

    split = {
        "step_ms": med(lambda: model._step(state)),
        "rotation1_ms": med(lambda: ring_sweep(rk.ring_grad_phase, model, F,
                                               grad_accs(F))),
        "fold_ms": med(lambda: ring_fold(model, F, gn, ln)),
        "rotation2_ms": med(lambda: ring_sweep(rk.ring_cand_phase, model, F,
                                               cand_accs(F, s), grad=grad)),
        # the step's route: the epilogue kernel per shard, the column sums
        # and the histogram in torch
        "armijo_ms": med(lambda: [
            armijo_tail_select_sharded(F[i], grad[i], node_llh[i], cb[i], sumF[i], cfg,
                                       kernel=True)
            for i in range(len(F))
        ]),
        "psums_ms": med(psums),
    }
    split["other_ms"] = split["step_ms"] - sum(
        v for name, v in split.items() if name != "step_ms"
    )
    # the route the kernel replaced, beside the split
    split["torch_armijo_ms"] = med(lambda: [
        armijo_tail_select_sharded(F[i], grad[i], node_llh[i], cb[i], sumF[i], cfg)
        for i in range(len(F))
    ])
    return split


def phase_ring_dp4(g, F0, main_hist):
    """RingBigClamModel at full width on 4 shards of one card, 5 steps of
    csr_ring_fused from main's F0, then 2 of csr_ring; one step timed in
    parts and traced; peak device memory. The planted graph's ids are
    locality-ordered (contiguous blocks), so without the balance
    relabeling nearly every edge would sit in a diagonal bucket; balanced,
    every (shard, phase) bucket holds a quarter of a shard's edges, the
    layout a multi-card ring runs."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import RingBigClamModel

    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=4, conv_tol=0.0)
    t0 = time.perf_counter()
    model = RingBigClamModel(g, cfg, repeated_mesh(RING_DP), balance=True)
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    state, fused = fit_mesh(
        model, F0, "csr_ring_fused", main_hist,
        lambda c, steps: ring_launches_want(c, RING_DP, steps),
    )
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = fused["launches"]
    model.cfg = cfg.replace(csr_fused=False, max_iters=1)
    model.rebuild_step()
    _, split_path = fit_mesh(
        model, F0, "csr_ring", main_hist,
        lambda c, steps: ring_launches_want(c, RING_DP, steps),
    )
    model.cfg = cfg
    model.rebuild_step()
    step = ring_step_split(model, state)
    step["profile"] = profile_call(lambda: model._step(state))
    return model, state, counts, {
        "dp": RING_DP, "devices": [str(d) for d in model.devices],
        "balanced": model._perm is not None, "model_build_s": build_s,
        "bucket_edges": bucket_edges(model), "csr_ring_fused": fused,
        "csr_ring": split_path, "step": step, "peak_device_gb": peak_gb,
    }


def ring_bounds(model, k: int, s: int) -> dict:
    """Least time of one sweep of kernel #8 / #9 over all dp*dp buckets at
    these inputs: per launch the bucket's CSR, F_rot (n_loc rows), and for
    the nz rows with an edge in the bucket F_u (and grad_u for #9) read
    and the accumulator read and written once; operations as kernels B
    and C's neighbour terms count them (`bounds`): 4K (+3) per edge for
    #8, S (2K + 2) per edge plus 3K per nz row and candidate (building
    nf_s) for #9, at the live K. For #8 also the floor of a sweep that
    finds no gathered row in L2: one F_rot row read per edge instead of
    per launch (`no_reuse_bytes`, `no_reuse_ms`)."""
    nbytes = {"ring_grad_phase": 0.0, "ring_cand_phase": 0.0}
    ops = {"ring_grad_phase": 0.0, "ring_cand_phase": 0.0}
    no_reuse = 0.0
    for row in model.buckets:
        for b in row:
            n_loc, e = b.num_nodes, b.num_directed_edges
            nz = int((b.indptr[1:] > b.indptr[:-1]).sum())
            csr = 8.0 * (n_loc + 1) + 4.0 * e
            nbytes["ring_grad_phase"] += csr + 4.0 * k * (n_loc + 3 * nz) + 8.0 * nz
            nbytes["ring_cand_phase"] += csr + 4.0 * k * (n_loc + 2 * nz) + 8.0 * s * nz
            no_reuse += csr + 4.0 * k * (e + 3 * nz) + 8.0 * nz
            ops["ring_grad_phase"] += e * (4.0 * k + 3)
            ops["ring_cand_phase"] += e * s * (2.0 * k + 2) + nz * s * 3.0 * k
    out = {}
    for name in nbytes:
        tb, to = nbytes[name] / PEAK_BYTES_PER_S, ops[name] / PEAK_FP32_PER_S
        out[name] = {"bound_ms": max(tb, to) * 1e3,
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": nbytes[name], "ops": ops[name]}
    out["ring_grad_phase"].update(no_reuse_bytes=no_reuse,
                                  no_reuse_ms=no_reuse / PEAK_BYTES_PER_S * 1e3)
    return out


def phase_ring_full(model, state):
    """#8 and #9 vs plain over every (shard, phase) bucket of ring_dp4's
    layout on its final F, each timed per sweep of all 16 buckets as
    `full` times kernels; #8 under every visit order, bit-equal to the
    identity order and timed per sweep; the node pass's epilogue of every
    shard vs plain, timed over the 4 shards beside torch armijo_update."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.ops.linesearch import (
        armijo_tail_select, armijo_tail_select_plain, armijo_update,
    )

    F, cfg = state.F, model.cfg
    orders = {"model_order": model.visit_order,
              "rows_visited": visit_orders_agree(model, F),
              "sweep_ms": visit_order_ms(model, F)}
    s = len(cfg.step_candidates)
    checks = {n: Check(n) for n in (*RING, "armijo_tail_select")}
    sumF, grad, node_llh, cb = ring_epilogues(checks["armijo_tail_select"], "full",
                                              model, F)
    compare_ring_kernels(checks, model, F, grad, cfg, "full")
    gacc, cacc = grad_accs(F), cand_accs(F, s)
    times = {
        "ring_grad_phase": time_pair(
            lambda: ring_sweep(rk.ring_grad_phase, model, F, gacc),
            lambda: ring_sweep(rk.ring_grad_phase_plain, model, F, gacc), reps=2),
        "ring_cand_phase": time_pair(
            lambda: ring_sweep(rk.ring_cand_phase, model, F, cacc, grad=grad),
            lambda: ring_sweep(rk.ring_cand_phase_plain, model, F, cacc, grad=grad),
            reps=2),
    }
    for t in times.values():
        t["library_ms"] = None
    # the node pass's epilogue over the shards, beside torch armijo_update
    dp = len(F)
    epilogue = time_pair(
        lambda: [armijo_tail_select(F[i], sumF[i], grad[i], node_llh[i], cb[i], cfg)
                 for i in range(dp)],
        lambda: [armijo_tail_select_plain(F[i], sumF[i], grad[i], node_llh[i], cb[i], cfg)
                 for i in range(dp)], reps=2)
    epilogue["torch_armijo_update_ms"] = statistics.median(time_ms(lambda: [
        armijo_update(F[i], sumF[i], grad[i], node_llh[i], cb[i], cfg, with_stats=True)
        for i in range(dp)], 3))
    epilogue.update(select_bound(sum(f.shape[0] for f in F), FULL["k"], s))
    side_by_side("ring_grad_phase", lambda: ring_sweep(
        rk.ring_grad_phase, model, F, grad_accs(F)))
    side_by_side("ring_cand_phase", lambda: ring_sweep(
        rk.ring_cand_phase, model, F, cand_accs(F, s), grad=grad))
    bnd = ring_bounds(model, FULL["k"], s)
    return checks, times, bnd, {
        "kernels": {n: {**checks[n].parts, **times[n], **bnd[n]} for n in RING},
        "armijo_tail_select": {**checks["armijo_tail_select"].parts,
                               "sweep_of_shards": epilogue},
        "launches_per_sweep": RING_DP * RING_DP, "k_pad": int(F[0].shape[1]),
        "visit_orders": orders,
        "unbalanced_layout": unbalanced_sweeps(model, state),
    }


def unbalanced_sweeps(model, state) -> dict:
    """Both ring kernels' sweeps on the same F laid out WITHOUT the balance
    relabeling: the planted blocks' rows stay contiguous, so a node's
    neighbour rows lie close together (and nearly every edge sits in a
    diagonal bucket)."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.parallel import RingBigClamModel

    raw = RingBigClamModel(model.g_original, model.cfg, repeated_mesh(RING_DP),
                           balance=False)
    F = raw.init_state(model.extract_F(state)).F
    gn, ln = ring_sweep(rk.ring_grad_phase, raw, F, grad_accs(F))
    _, grad, _ = ring_fold(raw, F, gn, ln)
    gacc, cacc = grad_accs(F), cand_accs(F, len(raw.cfg.step_candidates))
    med = lambda fn: statistics.median(time_ms(fn, 5))  # noqa: E731
    return {
        "bucket_edges": bucket_edges(raw),
        "ring_grad_phase_ms": med(lambda: ring_sweep(rk.ring_grad_phase, raw, F, gacc)),
        "ring_cand_phase_ms": med(lambda: ring_sweep(rk.ring_cand_phase, raw, F, cacc,
                                                     grad=grad)),
        "ring_grad_phase_visit_orders": {"model_order": raw.visit_order,
                                         "rows_visited": visit_orders_agree(raw, F),
                                         "sweep_ms": visit_order_ms(raw, F)},
    }


def phase_allgather_main(g, path, gi, F0, main_hist):
    """`cli fit --mesh 1,1` (all-gather, csr_fused) at full width, then
    ShardedBigClamModel on 4 shards of one card: 5 steps of csr_fused and
    2 of csr from main's F0."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import ShardedBigClamModel

    out, _, counts, _ = run_path(g, path, FULL["k"], ["--max-iters", "5", "--mesh", "1,1"])
    hist = out["llh_history"]
    if (out["kernel_path"], out.get("mesh")) != ("csr_fused", "1x1"):
        raise AssertionError(f"all-gather ran {out['kernel_path']} on {out.get('mesh')}")
    want = dict.fromkeys(counts, 0)
    want["fused_superstep"] = out["steps"]
    if counts != want:
        raise AssertionError(f"all-gather launches {counts}, want {want}")
    rel = llh_rel(hist, main_hist)
    if rel > LLH_RTOL:
        raise AssertionError(f"all-gather LLH {hist} vs csr_fused {main_hist}")
    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=4, conv_tol=0.0)
    model = ShardedBigClamModel(gi, cfg, repeated_mesh(RING_DP))

    def per_step(names):
        def want_fn(c, steps):
            w = dict.fromkeys(c, 0)
            w.update({n: RING_DP * steps for n in names})
            return w
        return want_fn

    _, dp_fused = fit_mesh(model, F0, "csr_fused", main_hist,
                           per_step(["fused_superstep"]))
    model.cfg = cfg.replace(csr_fused=False, max_iters=1)
    model.rebuild_step()
    _, dp_split = fit_mesh(model, F0, "csr", main_hist,
                           per_step(["grad_llh_csr", "candidates_csr"]))
    return {
        "cli": {"kernel_path": out["kernel_path"], "mesh": out["mesh"],
                "llh_history": hist, "max_rel_vs_csr_fused": rel,
                "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
                "stage_seconds": out["stage_seconds"], "launches": counts},
        "dp": RING_DP, "csr_fused": dp_fused, "csr": dp_split,
    }


def phase_ring_multi(g, F0, main_hist):
    """ring_dp4 on real cards (dp = min(4, count)): the hops are copies;
    overlapped and serial rotations give the same bits."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import RingBigClamModel, make_mesh

    count = torch.cuda.device_count()
    if count < 2:
        return {"skipped": f"needs two CUDA devices, this machine has {count}"}
    dp = min(RING_DP, count)
    mesh = make_mesh((dp, 1), [torch.device("cuda", i) for i in range(dp)])
    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=4, conv_tol=0.0)
    model = RingBigClamModel(g, cfg, mesh, balance=True)
    state, fused = fit_mesh(
        model, F0, "csr_ring_fused", main_hist,
        lambda c, steps: ring_launches_want(c, dp, steps),
    )
    serial = RingBigClamModel(g, cfg.replace(ring_overlap=False), mesh,
                              balance=True)
    a = serial._step(serial.init_state(F0))
    b = model._step(model.init_state(F0))
    if not (torch.equal(a.llh, b.llh)
            and all(torch.equal(x, y) for x, y in zip(a.F, b.F))):
        raise AssertionError("serial and overlapped rotations differ")
    def step_wall_ms():
        # host clock around a step, every card synchronized before and after
        for d in model.devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        model._step(state)
        for d in model.devices:
            torch.cuda.synchronize(d)
        return (time.perf_counter() - t0) * 1e3

    step_wall_ms()
    step_ms = statistics.median(step_wall_ms() for _ in range(5))
    return {"dp": dp, "devices": [str(d) for d in model.devices],
            "csr_ring_fused": fused, "step_ms": step_ms,
            "serial_equals_overlapped": True}


def phase_mesh_parity(tmp) -> dict:
    """N=2,400, K=100: ring and all-gather at dp = 4 on the card (float32
    kernels, balanced) against the port's CPU float64 `xla` at dp = 4 (not
    balanced) and on one device, 5 steps from one conductance init."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.parallel import (
        RingBigClamModel, ShardedBigClamModel, make_mesh,
    )

    path = os.path.join(tmp, "mesh_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    cfg = BigClamConfig(num_communities=PARITY["k"], max_iters=4, conv_tol=0.0)
    F0 = cli.init_F(g, cfg, "conductance")
    f64 = cfg.replace(dtype="float64")
    one = BigClamModel(g, f64, device="cpu").fit(F0).llh_history
    cpu_mesh = make_mesh((RING_DP, 1), ["cpu"] * RING_DP)
    out = {"cpu_f64_single_llh": one, "n": g.num_nodes, "edges": g.num_edges}
    for cls, want in ((RingBigClamModel, "csr_ring_fused"),
                      (ShardedBigClamModel, "csr_fused")):
        card = cls(g, cfg, repeated_mesh(RING_DP), balance=True)
        cpu = cls(g, f64, cpu_mesh, balance=False)
        if (card.engaged_path, cpu.engaged_path) != (want, "xla"):
            raise AssertionError((card.engaged_path, cpu.engaged_path))
        reset_launch_counts()
        a = card.fit(F0).llh_history
        counts = {n: c for n, c in launch_counts().items() if c}
        b = cpu.fit(F0).llh_history
        rel = max(llh_rel(a, b), llh_rel(a, one))
        if rel > LLH_RTOL or not counts:
            raise AssertionError(f"{want} card LLH {a} vs cpu float64 {b} / {one}")
        out[want] = {"gpu_llh": a, "cpu_f64_dp4_llh": b, "max_rel": rel,
                     "launches": counts}
    out["k_blocked"] = mesh_parity_kb(g, cfg.replace(csr_k_block=KB_PARITY_KC), F0,
                                      tmp, path)
    return out


def mesh_parity_kb(g, cfg, F0, tmp, path) -> dict:
    """The K-blocked meshes at csr_k_block = 32 on the parity graph: (4, 1)
    and (2, 2) on both schedules on the card against the CPU float64 `xla`
    on the same mesh (5 steps, LLH within LLH_RTOL); a (2, 2) fit
    checkpointed at step 2 and resumed, bit for bit the uninterrupted fit;
    `sweep --mesh 2,2 --csr-k-block 32` over (50, 100, 3) on the card
    against the CPU float64 sweep: the same grid and chosen K (unless a
    stop ratio lies within 1e-4 of ksweep_tol)."""
    from bigclam_tpu_torch.parallel import RingBigClamModel, ShardedBigClamModel, make_mesh
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    out = {}
    f64 = cfg.replace(dtype="float64", csr_k_block=0)
    for mesh in MESH_PARITY_KB:
        for cls, schedule in ((ShardedBigClamModel, "allgather"),
                              (RingBigClamModel, "ring")):
            kw = {"balance": False} if schedule == "ring" else {}
            card = cls(g, cfg, grid_mesh(*mesh), **kw)
            cpu = cls(g, f64, make_mesh(mesh, ["cpu"] * (mesh[0] * mesh[1])), **kw)
            if cpu.engaged_path != "xla" or card.kc != KB_PARITY_KC:
                raise AssertionError((card.engaged_path, card.kc, cpu.engaged_path))
            reset_launch_counts()
            a = card.fit(F0).llh_history
            counts = {n: c for n, c in launch_counts().items() if c}
            b = cpu.fit(F0).llh_history
            rel = llh_rel(a, b)
            if rel > LLH_RTOL or len(a) != len(b):
                raise AssertionError(f"{card.engaged_path} {mesh} LLH {a} vs cpu {b}")
            out[f"{card.engaged_path}_{mesh[0]}x{mesh[1]}"] = {
                "gpu_llh": a, "cpu_f64_llh": b, "max_rel": rel, "launches": counts}
    # checkpoint and resume on the (2, 2) mesh
    ck = cfg.replace(checkpoint_every=1)
    full = ShardedBigClamModel(g, ck, grid_mesh(2, 2)).fit(F0)
    cm = CheckpointManager(os.path.join(tmp, "mesh_parity_ckpt"))
    ShardedBigClamModel(g, ck.replace(max_iters=MESH_PARITY_CKPT_AT), grid_mesh(2, 2)).fit(
        F0, checkpoints=cm)
    res = ShardedBigClamModel(g, ck, grid_mesh(2, 2)).fit(F0, checkpoints=cm)
    if not np.array_equal(res.F, full.F) or (list(res.llh_history[-2:])
                                             != list(full.llh_history[-2:])):
        raise AssertionError("the resumed (2, 2) fit differs from the uninterrupted one")
    out["resume_2x2"] = {"checkpoint_at": MESH_PARITY_CKPT_AT, "bit_equal": True,
                         "llh_history": list(res.llh_history)}
    # sweep --mesh
    gpu, counts, _ = run_sweep(path, SWEEP_PARITY, [
        "--device", DEVICE, "--mesh", "2,2", "--csr-k-block", str(KB_PARITY_KC)])
    cpu, _, _ = run_sweep(path, SWEEP_PARITY, ["--device", "cpu", "--dtype", "float64"])
    llh = [cpu["llh_by_k"][str(k)] for k in cpu["kset"] if str(k) in cpu["llh_by_k"]]
    ratios = [1.0 - b / a for a, b in zip(llh, llh[1:])]
    near_tie = any(abs(r - 1e-3) <= 1e-4 for r in ratios)
    if gpu["kset"] != cpu["kset"] or (gpu["chosen_k"] != cpu["chosen_k"] and not near_tie):
        raise AssertionError(f"sweep --mesh 2,2 chose {gpu['chosen_k']} on "
                             f"{gpu['kset']}, cpu float64 {cpu['chosen_k']} on {cpu['kset']}")
    common = [k for k in gpu["llh_by_k"] if k in cpu["llh_by_k"]]
    rel = max(abs(gpu["llh_by_k"][k] - cpu["llh_by_k"][k]) / abs(cpu["llh_by_k"][k])
              for k in common)
    if rel > LLH_RTOL:
        raise AssertionError(f"sweep --mesh LLH {gpu['llh_by_k']} vs {cpu['llh_by_k']}")
    out["sweep_mesh_2x2"] = {"kset": gpu["kset"], "chosen_k": [gpu["chosen_k"],
                                                               cpu["chosen_k"]],
                             "max_rel": rel, "stop_ratios": ratios,
                             "launches": {n: c for n, c in counts.items() if c}}
    return out


# --- the K-blocked and K-sharded meshes --------------------------------------

# kbmesh_xlk's `cli fit` runs: (schedule, mesh, --csr-fused, iterations,
# the path it must take)
KBMESH_RUNS = (
    ("allgather", (4, 1), "auto", 5, "csr_fused_kb"),
    ("ring", (4, 1), "auto", 5, "csr_ring_fused_kb"),
    ("allgather", (2, 2), "auto", 5, "csr_fused_kb"),
    ("ring", (2, 2), "auto", 5, "csr_ring_fused_kb"),
    ("allgather", (4, 1), "off", 1, "csr_grouped_kb"),
    ("ring", (4, 1), "off", 1, "csr_ring_kb"),
)
TP_FULL_RUNS = (("allgather", "csr_fused"), ("ring", "csr_ring_fused"))
STORE_KB_ITERS = 1
MESH_PARITY_KB = ((4, 1), (2, 2))
MESH_PARITY_CKPT_AT = 2


# the memory model against a mesh run's measured peak: modeled / measured
# within 1 +- PEAK_BAND, and not below 1 at tp > 1, where obs/memory.py
# prices the torch tails' block temporaries (tp_tails_buffers)
PEAK_BAND = 0.25


def check_peak(tag: str, measured: float, modeled: float, tp: int) -> float:
    """modeled / measured of one mesh run, checked against PEAK_BAND."""
    ratio = modeled / measured
    if not 1 - PEAK_BAND <= ratio <= 1 + PEAK_BAND or (tp > 1 and ratio < 1):
        raise AssertionError(f"{tag}: modeled {modeled / 1e9:.3f} GB against a "
                             f"measured peak of {measured / 1e9:.3f} GB")
    return ratio


def mesh_launches(counts: dict, name: str) -> int:
    """A K-blocked kernel's launches in a mesh run: cand_from_x.cu's two
    entries (the node pass, the neighbour sums) together."""
    if name == "cand_from_x":
        return counts["cand_from_x"] + counts["cand_select_from_x"]
    return counts[name]


def tp_launches_want(counts, schedule: str, dp: int, tp: int, n_kb: int,
                     steps: int) -> dict:
    """The launches `steps` TP-split steps imply. All-gather, per step and
    block (dp tp of them): each window kernel once a window (n_kb), and
    either the node pass once a shard (tp = 1) or cand_nbr_from_x once a
    block (tp > 1). The ring does the same per (block, phase) bucket (dp
    phases), with cand_nbr_from_x once a bucket and, at tp = 1, the
    epilogue once a shard."""
    want = dict.fromkeys(counts, 0)
    per = dp * tp * (dp if schedule == "ring" else 1)
    want.update(edge_dots_kb=per * n_kb * steps, grad_from_x=per * n_kb * steps,
                cand_dots_kb=per * n_kb * steps)
    if schedule == "ring":
        want["cand_from_x"] = per * steps
        if tp == 1:
            want["armijo_tail_select"] = dp * steps
    elif tp == 1:
        want["cand_select_from_x"] = dp * steps
    else:
        want["cand_from_x"] = per * steps
    return want


def grid_mesh(dp: int, tp: int):
    """A (dp, tp) mesh on one card (the device repeated)."""
    from bigclam_tpu_torch.parallel import make_mesh

    return make_mesh((dp, tp), [torch.device(DEVICE)] * (dp * tp))


def mesh_run(g, path, k, schedule, mesh, fused, iters, want_path, ref_hist):
    """`cli fit --mesh DP,TP` on the card with the launch counters zeroed
    around it: the path, the launches the schedule implies, the LLH within
    LLH_RTOL of the one-card reference, the peak device memory beside the
    fit's modeled bytes (check_peak)."""
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan

    dp, tp = mesh
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, _, counts, _ = run_path(g, path, k, [
        "--max-iters", str(iters), "--mesh", f"{dp},{tp}", "--schedule", schedule,
        "--csr-fused", fused])
    peak = torch.cuda.max_memory_allocated() - base
    if (out["kernel_path"], out.get("mesh")) != (want_path, f"{dp}x{tp}"):
        raise AssertionError(f"ran {out['kernel_path']} on {out.get('mesh')}, "
                             f"want {want_path} on {dp}x{tp}")
    modeled = out.get("hbm_modeled_bytes", 0.0)
    ratio = check_peak(f"{want_path} {dp}x{tp}", peak, modeled, tp)
    kc, k_pad = mesh_k_plan(k, tp, True)
    n_kb = (k_pad // tp) // (kc or k_pad // tp)
    want = tp_launches_want(counts, schedule, dp, tp, n_kb, out["steps"])
    if counts != want:
        raise AssertionError(f"{want_path} {dp}x{tp} launches {counts}, want {want}")
    hist = out["llh_history"]
    rel = llh_rel(hist, ref_hist[: len(hist)])
    if rel > LLH_RTOL:
        raise AssertionError(f"{want_path} {dp}x{tp} LLH {hist} vs one card {ref_hist}")
    return {
        "kernel_path": want_path, "mesh": out["mesh"], "kc": kc, "k_pad": k_pad,
        "windows_per_block": n_kb, "llh_history": hist, "max_rel_vs_one_card": rel,
        "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
        "launches": counts, "peak_gb_measured": peak / 1e9,
        "peak_gb_modeled": modeled / 1e9, "peak_modeled_over_measured": ratio,
        "comms_bytes_per_step": out.get("comms_bytes_per_step"),
        "stage_seconds": out["stage_seconds"],
    }


def mesh_step_split(g, k, schedule, mesh, F_host) -> dict:
    """One fused mesh step from F_host on a repeated-card mesh, warm, then
    timed whole and split into its parts (utils.profiling.step_split: the
    all-gather or the sumF psums, the edge dots, the k psums, the consume
    (the gradient windows and the candidate dots, and the ring's neighbour
    candidate sums), the tails (node pass, epilogue or torch tails), the
    ring's hops alone (on one card a hop moves nothing), the closing
    psums)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import RingBigClamModel, ShardedBigClamModel
    from bigclam_tpu_torch.utils.profiling import step_split

    cfg = BigClamConfig(num_communities=k)
    cls = RingBigClamModel if schedule == "ring" else ShardedBigClamModel
    kw = {"balance": False} if schedule == "ring" else {}
    model = cls(g, cfg, grid_mesh(*mesh), **kw)
    state = model.init_state(F_host)
    state = model._step(state)
    whole = statistics.median(time_ms(lambda: model._step(state), 3))
    with step_split() as parts:
        model._step(state)
    del model, state
    return {"step_ms": whole, "split_ms": parts}


def phase_kbmesh_xlk(g, path, kb_hist, F_kb) -> tuple:
    """xl_k through the port's `cli fit` on mesh_run's KBMESH_RUNS, each
    against kb_main's one-card csr_fused_kb history (the same conductance
    F0); a step split of the fused runs from kb_main's F; and the dots'
    directed mode against the pair mode on the whole graph at xl_k (bit
    for bit, both timed per step of 3 windows)."""
    from bigclam_tpu_torch.models.bigclam import k_block_plan
    from bigclam_tpu_torch.ops import kblocked as kb

    out, counts_by = {}, {}
    for schedule, mesh, fused, iters, want in KBMESH_RUNS:
        tag = f"{want}_{mesh[0]}x{mesh[1]}"
        body = mesh_run(g, path, XLK["k"], schedule, mesh, fused, iters, want, kb_hist)
        if fused == "auto":
            body.update(mesh_step_split(g, XLK["k"], schedule, mesh, F_kb))
        out[tag] = body
        counts_by[tag] = body["launches"]

    kc, k_pad = k_block_plan(XLK["k"])
    dev = torch.device(DEVICE)
    csr = kb.with_rev(g.to_device(dev))
    F = torch.nn.functional.pad(torch.as_tensor(F_kb, dtype=torch.float32, device=dev),
                                (0, k_pad - XLK["k"])).contiguous()
    x_pair = torch.zeros(csr.num_directed_edges, device=dev)
    x_dir = torch.zeros_like(x_pair)

    def dots(x, directed):
        x.zero_()
        for col0 in range(0, k_pad, kc):
            kb.edge_dots_kb(F, csr, col0, kc, x, directed=directed)

    dots(x_pair, False)
    dots(x_dir, True)
    torch.cuda.synchronize()
    if not torch.equal(x_dir, x_pair):
        raise AssertionError("edge_dots_kb's directed mode differs from the pair mode")
    runs = {"pair": [], "directed": []}
    for seq in (("pair", "directed"), ("directed", "pair")):
        for mode in seq:
            runs[mode] += time_ms(lambda: dots(x_pair if mode == "pair" else x_dir,
                                               mode == "directed"))
    out["edge_dots_kb_modes"] = {
        "bit_equal": True, "windows": k_pad // kc,
        "pair_ms": statistics.median(runs["pair"]),
        "directed_ms": statistics.median(runs["directed"]),
    }
    return counts_by, out


def phase_tp_full(gi, F0, main_hist, main_sec) -> tuple:
    """`full` on a (2, 2) mesh of one card on both schedules from mesh_init's
    F0 (K = 1,000: k_pad 1,024, K_loc 512 in one window, the TP split with
    its k psums and the tails in torch), 5 steps: the launches the
    schedule implies, the LLH within LLH_RTOL of main's csr_fused history,
    seconds a step beside main's, peak device memory beside the model's
    (check_peak), and a step split as kbmesh_xlk's."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import RingBigClamModel, ShardedBigClamModel

    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=4, conv_tol=0.0)
    out, counts_by = {"main_sec_per_iter": main_sec}, {}
    for (schedule, want), cls in zip(TP_FULL_RUNS, (ShardedBigClamModel,
                                                    RingBigClamModel)):
        kw = {"balance": False} if schedule == "ring" else {}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = cls(gi, cfg, grid_mesh(2, 2), **kw)
        want_fn = lambda c, steps, s=schedule: tp_launches_want(  # noqa: E731
            c, s, 2, 2, 1, steps)
        state, body = fit_mesh(model, F0, want, main_hist, want_fn)
        peak, modeled = torch.cuda.max_memory_allocated() - base, model.memory.hbm_bytes()
        body.update(peak_gb_measured=peak / 1e9, peak_gb_modeled=modeled / 1e9,
                    peak_modeled_over_measured=check_peak(f"{want} 2x2", peak,
                                                          modeled, 2),
                    k_pad=model.k_pad, kc=model.kc)
        whole = statistics.median(time_ms(lambda: model._step(state), 3))
        from bigclam_tpu_torch.utils.profiling import step_split

        with step_split() as parts:
            model._step(state)
        body.update(step_ms=whole, split_ms=parts)
        del model, state
        out[f"{want}_2x2"] = body
        counts_by[f"{want}_2x2"] = body["launches"]
    return counts_by, out


def phase_store_kb(path, tmp) -> dict:
    """`cli ingest --shards 4` of xl_k, then `cli fit --store-native
    --mesh 4,1` at K = 3,000 (csr_fused_kb) from the cache against the
    in-memory `--mesh 4,1` fit of the same cache: the fitted F bit for bit
    and the LLH histories equal."""
    from bigclam_tpu_torch import cli

    cache = os.path.join(tmp, "xl_k_cache")
    ing = ingest(path, cache, "--shards", "4")
    F, runs = {}, {}
    for tag, extra in (("store_native", ["--store-native"]), ("in_memory", [])):
        args = cli.build_parser().parse_args([
            "fit", "--graph", cache, "--k", str(XLK["k"]), "--init", "conductance",
            "--conv-tol", "0", "--device", DEVICE, "--quiet", "--mesh", "4,1",
            "--max-iters", str(STORE_KB_ITERS), *extra])
        reset_launch_counts()
        t0 = time.perf_counter()
        res_out, res, _ = cli.fit(args)
        F[tag] = res.F
        runs[tag] = {"kernel_path": res_out["kernel_path"],
                     "llh_history": res_out["llh_history"],
                     "sec_per_iter": res_out["sec_per_iter"],
                     "seconds": time.perf_counter() - t0,
                     "launches": {k: v for k, v in launch_counts().items() if v}}
    if runs["store_native"]["kernel_path"] != "csr_fused_kb":
        raise AssertionError(f"store-native ran {runs['store_native']['kernel_path']}")
    if not np.array_equal(F["store_native"], F["in_memory"]) or (
            runs["store_native"]["llh_history"] != runs["in_memory"]["llh_history"]):
        raise AssertionError("store-native K-blocked F differs from the in-memory fit's")
    shutil.rmtree(cache, ignore_errors=True)
    return {"ingest": ing, **runs, "F_bit_equal": True,
            "F_shape": list(F["store_native"].shape)}


# --- resilience: checkpoints, resume, rollback, telemetry, health ----------

RES_ITERS = 6             # resilience_full's fits: steps 0..6
RES_KILL_AT = 4           # the kill lands after the checkpoint at 4
RES_NAN_AT = 3
RES_HEALTH_ITERS = 10     # resilience_full (d): health samples at 0 and 10
RES_ODD_ITERS = 5
RESUME_RTOL = 1e-6        # a resume that is not bit for bit must stay here
# the sparse step's grad, candidate and sumF scatters are torch index_add_,
# whose CUDA atomic adds sum in a different order from run to run: two
# uninterrupted fits differ by ~2e-6 after 6 steps, so its resume is held
# to this band, and the two-fit spread is reported beside it
SPARSE_RESUME_RTOL = 1e-5
RES_ODD_M = 16
K_BLOCKED_COUNTERS = ("edge_dots_kb", "grad_from_x", "cand_dots_kb",
                      "cand_select_from_x")


def events_of(directory) -> list:
    from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME

    with open(os.path.join(directory, EVENTS_NAME)) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_telemetry(directory) -> dict:
    """Every event of a telemetry directory against the schema; the kinds
    counted."""
    from bigclam_tpu_torch.obs.schema import summarize_kinds, validate_events_file
    from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME

    n, errors = validate_events_file(os.path.join(directory, EVENTS_NAME))
    if errors or not n:
        raise AssertionError(f"{directory}: {n} events, schema errors {errors[:5]}")
    return {"events": n, "kinds": summarize_kinds(events_of(directory))}


def rollbacks_of(directory) -> list:
    return [[e["iter"], e["rollbacks"], e["resume_iter"], e["step_scale"], e["llh"]]
            for e in events_of(directory) if e["kind"] == "rollback"]


@contextlib.contextmanager
def telemetry_and_faults(directory, faults=None):
    """A RunTelemetry in `directory` and a fault plan installed around the
    body; both removed after it."""
    from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
    from bigclam_tpu_torch.resilience import FaultPlan, install_plan

    tel = install(RunTelemetry(directory, entry="chip_smoke"))
    install_plan(FaultPlan(faults) if faults else None)
    try:
        yield tel
    finally:
        install_plan(None)
        tel.finalize()
        uninstall(tel)


def res_fit_args(path, ck, tel, extra=()):
    return ["--graph", path, "--k", str(FULL["k"]), "--init", "conductance",
            "--conv-tol", "0", "--device", DEVICE, "--max-iters", str(RES_ITERS),
            "--checkpoint-dir", ck, "--checkpoint-every", "2",
            "--telemetry-dir", tel, "--health-every", "2", *extra]


def history_match(a, b, rtol: float = RESUME_RTOL) -> dict:
    """Two LLH histories: bit for bit, or their largest relative gap
    (which must stay within rtol)."""
    rel = llh_rel(list(a), list(b))
    if rel > rtol:
        raise AssertionError(f"resumed history {a} vs uninterrupted {b}")
    return {"bit_identical": list(a) == list(b), "max_rel": rel, "band": rtol}


def phase_resilience_full(g, path, tmp, gi, F0, main_out):
    """`cli fit` at full on csr_fused with checkpoints, telemetry, health
    and metrics (a); the same fit killed in a subprocess at fit.step 4
    (started beside (a)) and resumed (b); a NaN injected at 3 and rolled
    back (c); health every 10 against 0, the health pack and the snapshot
    refresh timed (d); peak memory with and without the rollback
    snapshot."""
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    # (b)'s fit, killed after the checkpoint at 4, runs in a subprocess
    # beside (a) (its start, 8 s of imports and the graph's parse, took 24
    # s of the script's 1,200 in turn); (a)'s seconds share the host with it
    args_b = res_fit_args(path, d("res_ck_b"), d("res_tel_b"))
    env = dict(os.environ)
    env["BIGCLAM_FAULTS"] = json.dumps(
        {"faults": [{"kind": "kill", "site": "fit.step", "at": RES_KILL_AT}]})
    killed_log = open(d("res_killed.log"), "w+")
    t0_b = time.perf_counter()
    killed = subprocess.Popen(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", "fit", *args_b, "--quiet"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.DEVNULL, stderr=killed_log, text=True)
    try:
        parts = resilience_full_a(d, path, main_out)
        rc = killed.wait(timeout=900)
    finally:
        if killed.poll() is None:
            killed.kill()
            killed.wait()
    killed_s = time.perf_counter() - t0_b
    killed_log.seek(0)
    killed_err = killed_log.read()
    killed_log.close()
    return resilience_full_rest(d, gi, F0, args_b, rc, killed_err, killed_s, parts)


def resilience_full_a(d, path, main_out) -> dict:
    """resilience_full's (a): the uninterrupted fit at full with
    checkpoints every 2, telemetry, health and metrics."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    args_a = res_fit_args(path, d("res_ck_a"), d("res_tel_a"),
                          ["--metrics", d("res_metrics.jsonl")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out_a, res_a, _ = cli.fit(fit_args(args_a))
    counts_a = launch_counts()
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    hist_a = out_a["llh_history"]
    if out_a["kernel_path"] != "csr_fused":
        raise AssertionError(f"resilience_full ran {out_a['kernel_path']}")
    if counts_a["fused_superstep"] != out_a["steps"] or len(hist_a) != RES_ITERS + 1:
        raise AssertionError(f"kernel A launches {counts_a} vs {out_a['steps']} steps")
    if not all(math.isfinite(v) for v in hist_a):
        raise AssertionError(f"non-finite history {hist_a}")
    tel_a = validate_telemetry(d("res_tel_a"))
    rep = json.load(open(os.path.join(d("res_tel_a"), "run_report.json")))
    save_s = rep["spans"]["seconds"]["fit/fit_loop/checkpoint"]
    saves = rep["spans"]["counts"]["fit/fit_loop/checkpoint"]
    cm = CheckpointManager(d("res_ck_a"))
    if cm.steps() != [2, 4, 6] or saves != 3:
        raise AssertionError(f"checkpoints {cm.steps()}, {saves} saves")
    archive_bytes = os.path.getsize(cm._path(6))
    health_a = [e["iter"] for e in events_of(d("res_tel_a")) if e["kind"] == "health"]
    if health_a != [0, 2, 4, 6]:
        raise AssertionError(f"health samples at {health_a}")
    metrics_lines = len(open(d("res_metrics.jsonl")).read().splitlines())
    steps_a = out_a["steps"]
    del res_a
    return {
        "kernel_path": out_a["kernel_path"], "llh_history": hist_a,
        "steps": steps_a, "launches": counts_a["fused_superstep"],
        "sec_per_iter": out_a["sec_per_iter"],
        "sec_per_iter_without_saves": (out_a["sec_per_iter"] * steps_a - save_s) / steps_a,
        "main_sec_per_iter": main_out["sec_per_iter"],
        "checkpoint_saves": saves, "checkpoint_save_s": save_s / saves,
        "checkpoint_bytes": archive_bytes, "peak_gb": peak_a,
        "health_samples": health_a, "metrics_lines": metrics_lines,
        "telemetry": tel_a, "stage_seconds": out_a["stage_seconds"],
        "shared_host_with_b": True,
    }


def resilience_full_rest(d, gi, F0, args_b, rc, killed_err, killed_s, a) -> dict:
    """resilience_full's (b) from the killed subprocess's end, (c), (d) and
    the peaks; `a` is (a)'s body."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel, clone_state, refresh_state
    from bigclam_tpu_torch.ops import diagnostics as dx
    from bigclam_tpu_torch.ops.fused import fused_superstep
    from bigclam_tpu_torch.ops.linesearch import accept_stats
    from bigclam_tpu_torch.resilience import read_lineage
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    hist_a = a["llh_history"]
    # (b) killed in a subprocess after the checkpoint at 4, then resumed
    if rc != -9 or "FAULT kill" not in killed_err:
        raise AssertionError(f"the killed fit ended rc {rc}: {killed_err[-2000:]}")
    valid = CheckpointManager(d("res_ck_b")).latest_valid_step()
    if valid != RES_KILL_AT:
        raise AssertionError(f"newest valid checkpoint {valid}, want {RES_KILL_AT}")
    reset_launch_counts()
    out_b, _, _ = cli.fit(fit_args(args_b))
    counts_b = launch_counts()
    if counts_b["fused_superstep"] != RES_ITERS - RES_KILL_AT + 1:
        raise AssertionError(f"resumed fit launched {counts_b}")
    resume = history_match(out_b["llh_history"], hist_a)
    lineage = read_lineage(d("res_tel_b"))
    if [e["resumed_step"] for e in lineage] != [RES_KILL_AT]:
        raise AssertionError(f"resume lineage {lineage}")
    tel_b = validate_telemetry(d("res_tel_b"))

    # (c) a NaN at 3: rolled back, replayed on the scaled ladder
    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=RES_ITERS, conv_tol=0.0)
    model = BigClamModel(gi, cfg, device=DEVICE)
    state0 = model.init_state(F0)
    with telemetry_and_faults(d("res_tel_c"), [
            {"kind": "nan_inject", "site": "fit.step", "at": RES_NAN_AT}]) as tel:
        torch.cuda.synchronize()
        reset_launch_counts()
        _, _, _, hist_c = model.fit_state(state0)
        counts_c = launch_counts()
        syncs = tel.report()["spans"]["counts"]["fit_loop/sync"]
    rb = rollbacks_of(d("res_tel_c"))
    if [x[:4] for x in rb] != [[RES_NAN_AT, 1, 0, 0.1]] or isinstance(rb[0][4], float):
        raise AssertionError(f"rollback events {rb}")
    if counts_c["fused_superstep"] != syncs or syncs != RES_ITERS + 1 + 1 + RES_NAN_AT:
        raise AssertionError(f"kernel A launches {counts_c} vs {syncs} steps run")
    if not all(math.isfinite(v) for v in hist_c) or len(hist_c) != RES_ITERS + 1:
        raise AssertionError(f"rolled-back history {hist_c}")
    if model.cfg != cfg:
        raise AssertionError("the step cut leaked out of the fit")
    tel_c = validate_telemetry(d("res_tel_c"))

    # (d) health every 10 against 0, each fit of 11 steps twice, in the
    # order 0, 10, 10, 0; then the pack and the snapshot refresh alone
    def timed_fit(every, tag):
        m = BigClamModel(gi, cfg.replace(max_iters=RES_HEALTH_ITERS,
                                         health_every=every), device=DEVICE)
        with telemetry_and_faults(d(f"res_tel_d{every}_{tag}")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, _, h = m.fit_state(state0)
            wall = time.perf_counter() - t0
        health = [e["iter"] for e in events_of(d(f"res_tel_d{every}_{tag}"))
                  if e["kind"] == "health"]
        return wall / len(h), health, h

    runs = {0: [], 10: []}
    hists = {}
    for every, tag in ((0, "a"), (10, "a"), (10, "b"), (0, "b")):
        spi, health, h = timed_fit(every, tag)
        runs[every].append(spi)
        hists.setdefault(every, h)
        if health != ([0, 10] if every else []):
            raise AssertionError(f"health every {every}: samples at {health}")
    if hists[0] != hists[10]:
        raise AssertionError("health changed the trajectory")
    F_new, grad, _, ok = fused_superstep(state0.F, state0.sumF, model.csr, cfg)
    hist_ok = accept_stats(ok)
    sumF_new = F_new.sum(dim=0)
    hcfg = cfg.replace(health_every=10)
    pack_ms = statistics.median(time_ms(lambda: dx.health_pack(
        hcfg, 0, state0.F, F_new, sumF_new, hist_ok, grad=grad)))
    twin = clone_state(state0)
    refresh_ms = statistics.median(time_ms(lambda: refresh_state(twin, state0)))
    del F_new, grad, ok, twin

    # peak device memory of a 2-step fit with and without the snapshot
    peaks = {}
    for budget in (3, 0, 3, 0):
        m = BigClamModel(gi, cfg.replace(max_iters=2, rollback_budget=budget),
                         device=DEVICE)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m.fit_state(state0)
        peaks.setdefault(budget, []).append(
            (torch.cuda.max_memory_allocated() - base) / 1e9)
        del m
    step_s = [statistics.mean(runs[0]), statistics.mean(runs[10])]
    # two samples in an 11-step fit: the cost of one sample, and its share
    # of a step at cadence 10 in a long fit
    sample_ms = (step_s[1] - step_s[0]) * (RES_HEALTH_ITERS + 1) / 2 * 1e3
    return {
        "a": a,
        "b": {
            "killed_rc": rc, "killed_s": killed_s,
            "resumed_from": valid, "resumed_launches": counts_b["fused_superstep"],
            "llh_history": out_b["llh_history"], **resume,
            "sec_per_iter": out_b["sec_per_iter"], "telemetry": tel_b,
        },
        "c": {
            "rollbacks": rb, "llh_history": list(hist_c),
            "launches": counts_c["fused_superstep"], "steps_run": syncs,
            "telemetry": tel_c,
        },
        "d": {
            "sec_per_iter_health0": runs[0], "sec_per_iter_health10": runs[10],
            "health_overhead": step_s[1] / step_s[0] - 1.0,
            "health_sample_ms": sample_ms,
            "health_share_at_cadence_10": sample_ms / 10 / (step_s[0] * 1e3),
            "health_pack_ms": pack_ms, "snapshot_refresh_ms": refresh_ms,
            "trajectory_bit_identical": True,
        },
        "peak_gb_fit_with_snapshot": peaks[3], "peak_gb_fit_without_snapshot": peaks[0],
        "snapshot_gb": state0.F.numel() * state0.F.element_size() / 1e9,
    }


def phase_resilience_kb(g, F_host) -> dict:
    """A NaN on csr_fused_kb at xl_k from kb_main's F: the rollback, then
    the node pass (cand_select_from_x) and the window kernels on the
    scaled ladder, every launch of the replay counted."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    cfg = BigClamConfig(num_communities=XLK["k"], max_iters=4, conv_tol=0.0)
    model = BigClamModel(g, cfg, device=DEVICE)
    if model.engaged_path != "csr_fused_kb":
        raise AssertionError(f"resilience_kb ran {model.engaged_path}")
    state0 = model.init_state(np.asarray(F_host, np.float64))
    with tempfile.TemporaryDirectory() as tdir:
        with telemetry_and_faults(tdir, [
                {"kind": "nan_inject", "site": "fit.step", "at": 2}]) as tel:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            _, _, _, hist = model.fit_state(state0)
            wall = time.perf_counter() - t0
            counts = launch_counts()
            syncs = tel.report()["spans"]["counts"]["fit_loop/sync"]
        rb = rollbacks_of(tdir)
        tel_kb = validate_telemetry(tdir)
    n_kb = model.k_pad // model.kc
    want = {"cand_select_from_x": syncs, "edge_dots_kb": n_kb * syncs,
            "grad_from_x": n_kb * syncs, "cand_dots_kb": n_kb * syncs}
    if [x[:4] for x in rb] != [[2, 1, 0, 0.1]] or syncs != 5 + 1 + 2:
        raise AssertionError(f"rollbacks {rb}, {syncs} steps run")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"K-blocked launches {counts}, want {want}")
    if not all(math.isfinite(v) for v in hist) or model.cfg != cfg:
        raise AssertionError(f"history {hist}")
    return counts, {"rollbacks": rb, "llh_history": list(hist), "steps_run": syncs,
                    "launches": {k: counts[k] for k in want},
                    "seconds": wall, "telemetry": tel_kb}


def res_odd_models(g, cfg):
    """One card model per kernel path on the parity graph."""
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.models.sparse import SparseBigClamModel
    from bigclam_tpu_torch.parallel import RingBigClamModel

    return {
        "csr_fused": lambda: BigClamModel(g, cfg, device=DEVICE),
        "csr": lambda: BigClamModel(g, cfg.replace(csr_fused=False), device=DEVICE),
        "csr_fused_kb": lambda: BigClamModel(
            g, cfg.replace(csr_k_block=KB_PARITY_KC), device=DEVICE),
        "csr_grouped_kb": lambda: BigClamModel(
            g, cfg.replace(csr_k_block=KB_PARITY_KC, csr_fused=False), device=DEVICE),
        "pallas_vmem": lambda: BigClamModel(g, cfg.replace(use_pallas_csr=False),
                                            device=DEVICE),
        "sparse_merge_pallas": lambda: SparseBigClamModel(
            g, cfg.replace(representation="sparse", sparse_m=RES_ODD_M), device=DEVICE),
        "csr_ring_fused": lambda: RingBigClamModel(g, cfg, repeated_mesh(RING_DP)),
    }


def phase_resilience_odd(tmp) -> dict:
    """The parity graph on every card path: a NaN in F reaches the LLH and
    rolls back (the survival clamp's fmaxf drops a NaN, so the loop's view
    is checked, not assumed); A, B, C, the node pass and its epilogue
    against their plain versions on the scaled ladder (step_scale 0.1);
    a resume on the sparse and the dp = 4 ring paths against the
    uninterrupted fit."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.ops.csr_kernels import grad_llh_csr_plain
    from bigclam_tpu_torch.ops.linesearch import candidates_pass
    from bigclam_tpu_torch.ops.objective import EdgeChunks
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    path = os.path.join(tmp, "res_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    F0 = np.random.default_rng(PARITY["seed"] + 7).uniform(
        0.0, 1.0, (g.num_nodes, PARITY["k"]))
    cfg = BigClamConfig(num_communities=PARITY["k"], max_iters=RES_ODD_ITERS,
                        conv_tol=0.0)
    kernels_of = {
        "csr_fused": ("fused_superstep",),
        "csr": ("grad_llh_csr", "candidates_csr"),
        "csr_fused_kb": K_BLOCKED_COUNTERS, "csr_grouped_kb": K_BLOCKED_COUNTERS,
        "pallas_vmem": ("candidate_edge_terms", "armijo_tail_select"),
        "sparse_merge_pallas": ("member_lookup", "cand_sweep"),
        "csr_ring_fused": ("ring_grad_phase", "ring_cand_phase",
                           "armijo_tail_select"),
    }
    paths = {}
    for name, make in res_odd_models(g, cfg).items():
        model = make()
        if model.engaged_path != name:
            raise AssertionError(f"{name}: ran {model.engaged_path}")
        tdir = os.path.join(tmp, f"res_odd_{name}")
        with telemetry_and_faults(tdir, [{"kind": "nan_inject", "site": "fit.step",
                                          "at": 2, "index": [0, 0]}]) as tel:
            state0 = model.init_state(F0)
            torch.cuda.synchronize()
            reset_launch_counts()
            _, _, _, hist = model.fit_state(state0)
            counts = launch_counts()
            syncs = tel.report()["spans"]["counts"]["fit_loop/sync"]
        rb = rollbacks_of(tdir)
        if [x[:4] for x in rb] != [[2, 1, 0, 0.1]] or isinstance(rb[0][4], float):
            raise AssertionError(f"{name}: rollback events {rb}")
        if not all(math.isfinite(v) for v in hist) or len(hist) != RES_ODD_ITERS + 1:
            raise AssertionError(f"{name}: history {hist}")
        launched = {k: counts[k] for k in kernels_of[name]}
        if not all(launched.values()):
            raise AssertionError(f"{name}: kernels not launched {launched}")
        paths[name] = {"nonfinite_llh": rb[0][4], "steps_run": syncs,
                       "launches": launched, "llh_final": hist[-1]}
        validate_telemetry(tdir)

    # the kernels against plain on the scaled ladder
    F, csr, ocfg = odd_case()
    scaled = ocfg.replace(step_scale=0.1)
    checks = compare_kernels(F, csr, scaled)
    sumF = F.sum(dim=0)
    grad, node_llh = grad_llh_csr_plain(F, sumF, csr, scaled)
    cand = candidates_pass(F, grad, EdgeChunks(csr.src, csr.dst, 1 << 20), scaled)
    epi = Check("armijo_tail_select")
    check_epilogue(epi, "odd_scaled", F, sumF, grad, node_llh, cand, scaled)
    kb = kb_odd_case(KB_ODD_K, step_scale=0.1)

    # resume on the sparse path and the dp = 4 ring
    resumes = {}
    for name, band in (("sparse_merge_pallas", SPARSE_RESUME_RTOL),
                       ("csr_ring_fused", RESUME_RTOL)):
        make6 = res_odd_models(g, cfg.replace(max_iters=6))[name]
        make4 = res_odd_models(g, cfg.replace(max_iters=4, checkpoint_every=2))[name]
        m = make6()
        _, _, _, full = m.fit_state(m.init_state(F0))
        _, _, _, again = m.fit_state(m.init_state(F0))
        cm = CheckpointManager(os.path.join(tmp, f"res_ck_{name}"))
        m = make4()
        m.fit_state(m.init_state(F0), checkpoints=cm)
        m = make6()
        _, _, _, resumed = m.fit_state(m.init_state(F0), checkpoints=cm)
        if cm.steps()[:2] != [2, 4]:
            raise AssertionError(f"{name}: checkpoints {cm.steps()}")
        resumes[name] = {"resumed_from": 4, **history_match(resumed, full, band),
                         "two_fits_bit_identical": list(full) == list(again),
                         "two_fits_max_rel": llh_rel(list(full), list(again))}
    return {
        "n": g.num_nodes, "k": PARITY["k"], "paths": paths,
        "scaled_ladder": {
            **{n: c.parts for n, c in checks.items()},
            "armijo_tail_select": epi.parts,
            "kb": kb["kernels"],
        },
        "resume": resumes,
    }


# --- observability: memory and comms models, perf ledger, profiler ---------

OBS_STEPS = 2             # obs_memory's fits: steps 0..2 (3 steps run)
OBS_LEDGER_ITERS = 20     # obs_ledger's fits at the parity graph
OBS_PROFILE_STEPS = 3
# PR 13's step times on the H100 80GB HBM3 at 700 W (PERF.md section 5)
STEP_BEFORE_S = {"full": 0.0370, "xl_k": 0.00784}
# the hand kernels each profiled path must show, by the device function
# the profiler names (a substring of its demangled name)
PROFILE_KERNELS = {
    "full": {"fused_superstep": "fused_superstep_kernel"},
    "xl_k": {"cand_dots_kb": "cand_dots_kernel", "edge_dots_kb": "edge_dots_kernel",
             "grad_from_x": "grad_from_x_kernel", "cand_from_x": "node_pass_kernel"},
}
# kernels that would mean a library or a plain version computed the work
NOT_HAND = re.compile(r"gemm|cublas|cutlass|index_add|indexSelect|index_select|"
                      r"scatter|gather", re.IGNORECASE)


def obs_models(g, cell):
    """The models of each path the memory phase measures: those that
    `main`, `sparse_main`, `vmem_main`, `ring_main` and `ring_dp4` build at
    full, `kb_main`'s at xl_k (rollback on, as `cli fit` runs them)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.models.sparse import SparseBigClamModel
    from bigclam_tpu_torch.parallel import RingBigClamModel

    k = FULL["k"] if cell == "full" else XLK["k"]
    cfg = BigClamConfig(num_communities=k, max_iters=OBS_STEPS, conv_tol=0.0)
    if cell == "xl_k":
        return {"csr_fused_kb": lambda: BigClamModel(g, cfg, device=DEVICE)}
    return {
        "csr_fused": lambda: BigClamModel(g, cfg, device=DEVICE),
        "csr_fused_no_snapshot": lambda: BigClamModel(
            g, cfg.replace(rollback_budget=0), device=DEVICE),
        "sparse_merge_pallas": lambda: SparseBigClamModel(
            g, cfg.replace(representation="sparse", sparse_m=SPARSE_M),
            device=DEVICE),
        "pallas_vmem": lambda: BigClamModel(
            g, cfg.replace(use_pallas_csr=False), device=DEVICE),
        "csr_ring_fused_1x1": lambda: RingBigClamModel(g, cfg, repeated_mesh(1)),
        "csr_ring_fused_dp4": lambda: RingBigClamModel(g, cfg, repeated_mesh(RING_DP)),
    }


def model_k_pad(cell) -> int:
    """K_pad of the gated path's F at `cell`."""
    from bigclam_tpu_torch.models.bigclam import k_block_plan

    return k_block_plan(FULL["k"] if cell == "full" else XLK["k"])[1]


def phase_obs_memory(g, F0, cell) -> dict:
    """Each path's memory model against the card: the model built, F0
    uploaded and a fit of OBS_STEPS + 1 steps run with the allocated bytes
    before the model subtracted (torch.cuda's peak since a reset); the
    addressable reconcile (state + graph storage bytes, drift 0) on the
    uploaded and the final state; the modeled device bytes beside the
    measured peak. At full, `cli preflight` for the graph beside the
    csr_fused peak; the card's total memory against the preflight's table
    row."""
    import gc

    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.obs import memory as M

    out = {}
    for name, make in obs_models(g, cell).items():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = make()
        state = model.init_state(F0)
        r0 = model.memory_reconcile(state, emit=False)
        state, _, _, hist = model.fit_state(state)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        r1 = model.memory_reconcile(state, emit=False)
        for r in (r0, r1):
            if r["drift_frac"] != 0.0:
                raise AssertionError(f"{name}: addressable drift {r}")
        modeled = model.memory.hbm_bytes()
        out[name] = {
            "kernel_path": model.engaged_path,
            "addressable_bytes": r1["modeled_bytes"],
            "addressable_drift": [r0["drift_frac"], r1["drift_frac"]],
            "modeled_hbm_bytes": modeled,
            "measured_peak_bytes": peak,
            "modeled_over_measured": modeled / peak,
            "by_category": model.memory.category_bytes(),
            "steps_run": len(hist),
        }
        del model, state
    body = {"cell": cell, "n": g.num_nodes, "directed_edges": g.num_directed_edges,
            "paths": out}
    gate = "csr_fused" if cell == "full" else "csr_fused_kb"
    # the step's torch column sum of F_new, the largest temporary the model
    # leaves out: its bytes beyond its (K_pad,) output
    Fx = torch.ones((g.num_nodes, model_k_pad(cell)), device=DEVICE)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    col = Fx.sum(dim=0)
    torch.cuda.synchronize()
    body["unmodeled_colsum_bytes"] = (torch.cuda.max_memory_allocated() - before
                                      - col.numel() * col.element_size())
    del Fx, col
    ratio = out[gate]["modeled_over_measured"]
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"{gate}: modeled/measured {ratio} outside 10%")
    if cell == "full":
        kind = torch.cuda.get_device_name(0)
        total = torch.cuda.get_device_properties(0).total_memory
        if M.DEVICE_HBM_BYTES.get(kind) != total:
            raise AssertionError(f"{kind}: total_memory {total}, table "
                                 f"{M.DEVICE_HBM_BYTES.get(kind)}")
        args = cli.build_parser().parse_args([
            "preflight", "--nodes", str(g.num_nodes), "--edges", str(g.num_edges),
            "--k", str(FULL["k"]), "--device-kind", kind, "--json"])
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.preflight(args)
        p = json.loads(buf.getvalue())
        body["preflight"] = {
            "rc": rc, "fits": p["fits"], "kernel_path": p["workload"]["kernel_path"],
            "hbm_bytes_per_device": p["hbm_bytes_per_device"],
            "hbm_budget_bytes": p["hbm_budget_bytes"],
            "measured_peak_bytes": out["csr_fused"]["measured_peak_bytes"],
            "over_measured": p["hbm_bytes_per_device"]
            / out["csr_fused"]["measured_peak_bytes"],
        }
        body["card_total_memory"] = total
        if rc != 0 or p["workload"]["kernel_path"] != "csr_fused":
            raise AssertionError(f"preflight of full: rc {rc}, {p['workload']}")
    return body


def phase_obs_ledger(tmp) -> dict:
    """`cli fit --telemetry-dir --perf-ledger` twice at the parity graph
    into one temporary ledger: `perf diff` finds the first as the second's
    baseline and exits 0; a third fit with another --alpha finds none
    (exit 1). The records' digests, step medians and modeled bytes, and
    the port's `cli report --json` of the first run."""
    import io

    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.obs import ledger as L

    path = os.path.join(tmp, "obs_parity_graph.txt")
    planted_file(PARITY, path)
    led = os.path.join(tmp, "obs_ledger.jsonl")

    def fit(tag, *extra):
        args = fit_args(["--graph", path, "--k", str(PARITY["k"]), "--device", DEVICE,
                         "--max-iters", str(OBS_LEDGER_ITERS), "--conv-tol", "0",
                         "--telemetry-dir", os.path.join(tmp, f"obs_tel_{tag}"),
                         "--perf-ledger", led, *extra])
        return cli.fit(args)[0]

    def run_cli(*argv):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
        return rc, buf.getvalue(), err.getvalue()

    fit("a")
    fit("b")
    rc_same, diff_same, _ = run_cli("perf", "diff", "--ledger", led)
    fit("c", "--alpha", "0.1")
    rc_other, _, err_other = run_cli("perf", "diff", "--ledger", led)
    recs = L.PerfLedger(led).load()
    if rc_same != 0 or "vs baseline" not in diff_same:
        raise AssertionError(f"identical fits: perf diff rc {rc_same}\n{diff_same}")
    if rc_other != 1 or "no matched baseline" not in err_other:
        raise AssertionError(f"another --alpha: perf diff rc {rc_other} {err_other}")
    rc_rep, rep, _ = run_cli("report", os.path.join(tmp, "obs_tel_a"), "--json")
    rep = json.loads(rep)
    if rc_rep != 0 or not rep["memory_model"]:
        raise AssertionError(f"cli report rc {rc_rep}")
    return {
        "records": [{k: r.get(k) for k in ("run", "cfg_digest", "backend",
                                            "device_kind", "kernel_path", "step_p50",
                                            "hbm_modeled_bytes")} for r in recs],
        "diff_identical": {"rc": rc_same, "text": diff_same.splitlines()},
        "diff_other_alpha_rc": rc_other,
        "report_memory_model_hbm": rep["memory_model"]["hbm_bytes_per_device"],
    }


def phase_obs_profile(g, path, cell, F_host) -> dict:
    """`cli profile --steps 3` on `cell`'s graph file (g as read from it):
    the captured kernel table names each hand kernel of the path with
    device time > 0 and no library or plain-version kernel; the
    unprofiled step from F_host (utils.profiling.step_time, 10 steps, the
    observability layer off) beside PR 13's."""
    import io

    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.utils.profiling import step_time

    k = FULL["k"] if cell == "full" else XLK["k"]
    with tempfile.TemporaryDirectory() as pdir:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["profile", "--graph", path, "--k", str(k), "--device",
                           DEVICE, "--steps", str(OBS_PROFILE_STEPS), "--warmup", "1",
                           "--quiet", "--profile-dir", pdir])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        files = sorted(os.listdir(pdir))
    if rc != 0:
        raise AssertionError(f"cli profile rc {rc}")
    kernels = out["top_kernels"]
    found = {}
    for name, fn in PROFILE_KERNELS[cell].items():
        rows = [r for r in kernels if fn in r["name"]]
        if not rows or not all(r["device_ms"] > 0 for r in rows):
            raise AssertionError(f"{cell}: no {fn} with device time in {kernels}")
        found[name] = {"device_ms": sum(r["device_ms"] for r in rows),
                       "calls": sum(r["calls"] for r in rows)}
    bad = [r["name"] for r in kernels if NOT_HAND.search(r["name"])]
    if bad:
        raise AssertionError(f"{cell}: library or plain kernels {bad}")
    model = BigClamModel(g, BigClamConfig(num_communities=k), device=DEVICE)
    step_s = step_time(model._step, model.init_state(F_host), steps=10, warmup=2)
    del model
    return {
        "cell": cell, "kernel_path": out["kernel_path"],
        "sec_per_step_p50_profiled": out["sec_per_step_p50"],
        "files": files, "hand_kernels": found,
        "top_kernels": [[r["name"][:90], r["device_ms"], r["calls"]] for r in kernels],
        "unprofiled_step_s": step_s, "step_s_pr13": STEP_BEFORE_S[cell],
        "step_over_pr13": step_s / STEP_BEFORE_S[cell],
        "hbm_modeled_bytes": out.get("hbm_modeled_bytes"),
    }


# --------------------------------------------------------------------------
# the graph store: `cli ingest`, cache-fed fits, store-native meshes,
# self-heal and edge deltas at full width
# --------------------------------------------------------------------------

STORE_SHARDS = 4
STORE_ITERS = 4               # store_native_dp4's fits: steps 0..4
STORE_RING_RTOL = 1e-6        # the ring's band where two in-memory runs differ
DELTA_FRAC = 0.01             # store_delta: new edges, a share of the graph's
DELTA_SEED = 15


def cli_json(argv) -> dict:
    """The port's `cli.main(argv)` in-process: exit 0 and the JSON line it
    prints last."""
    import io

    from bigclam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def ingest_body(out: dict, seconds: float) -> dict:
    """The ingest JSON's numbers a phase prints."""
    return {
        "seconds": seconds, "stage_seconds": out["seconds"],
        "raw_edges": out["counts"]["raw_edges"],
        "directed_edges": out["counts"]["directed_edges"],
        "edges_per_s": out["edges_per_sec"],
        "edges_per_s_parse": out.get("edges_per_sec_parse"),
        "rss_delta_bytes": out["rss"]["delta_bytes"],
        "rss_peak_bytes": out["rss"]["peak_sampled_bytes"],
        "cache_bytes": dir_bytes(out["cache_dir"]),
        "n": out["n"], "edges": out["edges"], "shards": out["shards"],
        "balanced": out["balanced"], "seed_baked": out["seed_baked"],
        "closure_baked": out["closure_baked"],
    }


def ingest(path, cache, *flags) -> dict:
    t0 = time.perf_counter()
    out = cli_json(["ingest", "--graph", path, "--cache-dir", cache, *flags])
    return ingest_body(out, time.perf_counter() - t0)


def store_fit(extra, quiet: bool = True, k: int = 0):
    """`cli fit` at full width (or K = k, where given) with the launch
    counters zeroed just before and read just after; (out, res, counts,
    stderr text)."""
    import io

    from bigclam_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "fit", "--k", str(k or FULL["k"]), "--init", "conductance",
        "--conv-tol", "0", "--device", DEVICE,
        *(["--quiet"] if quiet else []), *extra,
    ])
    err = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stderr(err):
        out, res, _ = cli.fit(args)
    counts = launch_counts()
    hist = out["llh_history"]
    if not all(math.isfinite(v) for v in hist) or not np.isfinite(res.F).all():
        raise AssertionError(f"non-finite fit: {hist}")
    return out, res, counts, err.getvalue()


def same_graph(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in (
        (a.indptr, b.indptr), (a.indices, b.indices), (a.raw_ids, b.raw_ids)))


BAKED_NOTE = "using ingest-baked seed scores"


def phase_store_full(gi, path, tmp, F0, main_out, main_counts):
    """`cli ingest --shards 4` of main's edge list (seed scores and closure
    lists baked), then `cli fit --graph <cache>` at full: the baked scores
    used, F0 and the LLH history bit for bit main's, kernel A's launches
    main's; then `--cache-dir` on the parity graph's text, compiled once
    and reloaded, both on the text-fed fit's history."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.store import GraphStore

    cache = os.path.join(tmp, "full_s4.cache")
    ing = ingest(path, cache, "--shards", str(STORE_SHARDS))
    if not (ing["seed_baked"] and ing["closure_baked"]):
        raise AssertionError(f"ingest baked nothing: {ing}")
    store = GraphStore.open(cache)
    t0 = time.perf_counter()
    gc = store.load_graph()
    load_s = time.perf_counter() - t0
    if not same_graph(gc, gi):
        raise AssertionError("the cache's graph is not build_graph's")
    F0c = cli.init_F(gc, BigClamConfig(num_communities=FULL["k"]),
                     "conductance", store=store, quiet=True)
    if not np.array_equal(F0c, F0):
        raise AssertionError("the baked-score F0 is not main's")
    del gc, F0c
    out, _, counts, err = store_fit(["--graph", cache, "--max-iters", "5"],
                                    quiet=False)
    if BAKED_NOTE not in err:
        raise AssertionError("the cache-fed fit did not use the baked scores")
    if out["kernel_path"] != "csr_fused" or counts != main_counts:
        raise AssertionError(f"{out['kernel_path']} launches {counts}, main "
                             f"{main_counts}")
    if out["llh_history"] != main_out["llh_history"]:
        raise AssertionError(f"cache-fed history {out['llh_history']} vs main "
                             f"{main_out['llh_history']}")
    # --cache-dir on the parity graph's text: the first fit compiles, the
    # second reloads
    ppath = os.path.join(tmp, "cache_dir_graph.txt")
    planted_file(PARITY, ppath)
    # the text-fed fit seeded by exact host counts, as the bake seeds (on
    # the card `auto` would count on the device at this size)
    ref, _, _, _ = store_fit(["--graph", ppath, "--max-iters", "1", "--seed-backend",
                              "numpy"], k=PARITY["k"])
    cdir = os.path.join(tmp, "parity.cache")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        o, _, c, e = store_fit(["--graph", ppath, "--cache-dir", cdir,
                                "--max-iters", "1"], quiet=False, k=PARITY["k"])
        if o["llh_history"] != ref["llh_history"] or BAKED_NOTE not in e:
            raise AssertionError(f"--cache-dir history {o['llh_history']} vs "
                                 f"{ref['llh_history']}")
        runs.append({"compiled": "compiling graph cache" in e,
                     "wall_s": time.perf_counter() - t0,
                     "stage_seconds": o["stage_seconds"], "launches": c})
    if [r["compiled"] for r in runs] != [True, False]:
        raise AssertionError(f"--cache-dir compiled {runs}")
    main_stages = main_out["stage_seconds"]
    return cache, {
        "ingest": ing, "load_graph_s": load_s,
        "fit": {"kernel_path": out["kernel_path"],
                "llh_history": out["llh_history"],
                "bit_identical_to_main": True, "f0_equal_to_main": True,
                "baked_scores_used": True, "launches": counts,
                "sec_per_iter": out["sec_per_iter"],
                "stage_seconds": out["stage_seconds"]},
        "stages_vs_main_s": {name: [out["stage_seconds"][name], main_stages[name]]
                             for name in ("graph", "seeding")},
        "cache_dir_runs": runs, "cache_dir_bytes": dir_bytes(cdir),
    }


@contextlib.contextmanager
def host_peaks(period_s: float = 0.005):
    """The host memory a body takes: this process's RSS sampled on a thread
    (its peak over the baseline; in a long-lived process that reads how
    much the allocator had to grow, not what the body allocated) and
    tracemalloc's peak of the numpy and Python allocations made inside
    the body. Yields a dict that holds both after the body."""
    import threading
    import tracemalloc

    from bigclam_tpu_torch.utils.profiling import current_rss_bytes

    base = current_rss_bytes()
    peak = [base]
    stop = threading.Event()

    def run():
        while not stop.is_set():
            peak[0] = max(peak[0], current_rss_bytes())
            stop.wait(period_s)

    rec = {}
    th = threading.Thread(target=run, daemon=True)
    tracemalloc.start()
    th.start()
    try:
        yield rec
    finally:
        stop.set()
        th.join()
        rec["alloc_peak_bytes"] = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        rec["rss_peak_delta_bytes"] = max(peak[0], current_rss_bytes()) - base


def mesh_fit(model, F0, steps: int = STORE_ITERS) -> tuple:
    """(LLH history, final F on the host in the trainer's row order's
    original ids) of `steps` steps of a mesh model from F0."""
    model.cfg = model.cfg.replace(max_iters=steps, conv_tol=0.0)
    model.rebuild_step()
    state, _, _, hist = model.fit_state(model.init_state(F0))
    return list(hist), model.extract_F(state)


def phase_store_native_dp4(gi, path, tmp, cache, F0, ag_s, ring_s):
    """`cli fit --mesh 4,1 --store-native` on one card repeated four times:
    the unbalanced 4-shard cache under allgather and ring, and a balanced
    one (`ingest --balance --shards 4`) under ring, each held against the
    in-memory trainer on the same layout and F0 (bit for bit, or within
    the path's band where a second in-memory run differs from the first),
    each
    position's files_read its own shard's blobs, the host RSS of the
    store-native build beside the in-memory one."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.parallel import (
        RingBigClamModel,
        ShardedBigClamModel,
        StoreRingBigClamModel,
        StoreShardedBigClamModel,
    )

    # no bakes: the balanced fit seeds by scoring the relabeled graph (the
    # `auto` fallback), which keeps the phase's second ingest short
    bal_cache = os.path.join(tmp, "full_s4_balanced.cache")
    ing = ingest(path, bal_cache, "--shards", str(STORE_SHARDS), "--balance",
                 "--no-seed-bake", "--no-closure-bake")
    cfg = BigClamConfig(num_communities=FULL["k"], max_iters=STORE_ITERS,
                        conv_tol=0.0)
    mesh = repeated_mesh(STORE_SHARDS)
    cases = {}
    for name, cdir, schedule in (("allgather", cache, "allgather"),
                                 ("ring", cache, "ring"),
                                 ("ring_balanced", bal_cache, "ring")):
        store = GraphStore.open(cdir)
        ring = schedule == "ring"
        out, res, counts, _ = store_fit([
            "--graph", cdir, "--max-iters", str(STORE_ITERS),
            "--mesh", f"{STORE_SHARDS},1", "--store-native",
            "--schedule", schedule])
        want_path = "csr_ring_fused" if ring else "csr_fused"
        want = (ring_launches_want(counts, STORE_SHARDS, out["steps"]) if ring
                else {**dict.fromkeys(counts, 0),
                      "fused_superstep": STORE_SHARDS * out["steps"]})
        if out["kernel_path"] != want_path or counts != want:
            raise AssertionError(f"{name}: {out['kernel_path']} launches "
                                 f"{counts}, want {want}")
        # the F0 the CLI seeded (cache order; store_full found the
        # unbalanced cache's equal to main's) and the in-memory layout
        perm = store.load_perm()
        if perm is None:
            F0c = F0
        else:
            F0c = cli.init_F(store.load_graph(), cfg, "conductance",
                             store=store, quiet=True)
        store_cls = StoreRingBigClamModel if ring else StoreShardedBigClamModel
        mem_cls = RingBigClamModel if ring else ShardedBigClamModel
        with host_peaks() as host_store:
            sm = store_cls(store, cfg, mesh)
        want_files = [(f"shard_{s:05d}.indptr.npy", f"shard_{s:05d}.indices.npy")
                      for s in range(STORE_SHARDS)]
        if sm.files_read != want_files:
            raise AssertionError(f"{name}: files_read {sm.files_read}")
        del sm
        with host_peaks() as host_mem:
            mm = mem_cls(gi, cfg, mesh, balance=perm is not None)
        F0m = F0c if perm is None else F0c[perm]
        if ring and perm is not None and mm.visit_order != "pre_balance":
            raise AssertionError(f"visit order {mm.visit_order}")
        h1, F1 = mesh_fit(mm, F0m)
        F_store = res.F if perm is None else res.F[perm]
        hist = out["llh_history"]
        # a second in-memory run only where the first differs from the
        # store-native one: it decides whether the path's band applies
        # (None: not run, the store-native run was the first's bits)
        deterministic = None
        if hist != h1 or not np.array_equal(F_store, F1):
            h2, F2 = mesh_fit(mm, F0m)
            deterministic = h1 == h2 and np.array_equal(F1, F2)
        del mm
        if deterministic:
            raise AssertionError(f"{name}: store-native {hist} vs in-memory {h1}")
        rel = 0.0 if deterministic is None else llh_rel(hist, h1)
        if rel > (STORE_RING_RTOL if ring else 0.0):
            raise AssertionError(f"{name}: store-native {hist} vs "
                                 f"in-memory {h1} ({rel})")
        cases[name] = {
            "kernel_path": out["kernel_path"], "mesh": out["mesh"],
            "balanced": perm is not None, "llh_history": hist,
            "in_memory_llh_history": h1,
            "in_memory_runs_bit_identical": deterministic,
            "bit_identical": deterministic is None, "max_rel": rel,
            "launches": counts, "sec_per_iter": out["sec_per_iter"],
            "sec_per_iter_in_memory_phase": ring_s if ring else ag_s,
            "stage_seconds": out["stage_seconds"],
            "files_read": want_files,
            "host_build": {"store_native": host_store, "in_memory": host_mem,
                           "global_graph_bytes_in_memory": int(
                               gi.indptr.nbytes + gi.indices.nbytes
                               + gi.src.nbytes)},
        }
    return bal_cache, {"ingest_balanced": ing, "dp": STORE_SHARDS,
                       "devices": [str(d) for d in mesh.node_devices()],
                       **cases}


def phase_store_heal(path, tmp, cache, main_out):
    """corrupt_shard on shard 1 through the fault plan: the cache-fed fit
    quarantines the shard, rebuilds it from the source edge list and
    trains to main's history; with --no-self-heal `cli.main` raises
    ShardCorruption."""
    import shutil

    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.graph.store import QUARANTINE_DIR, ShardCorruption

    heal = os.path.join(tmp, "heal.cache")
    shutil.copytree(cache, heal)
    plan = [{"kind": "corrupt_shard", "site": "store.load_shard", "shard": 1}]
    tdir = os.path.join(tmp, "heal_tel")
    with telemetry_and_faults(tdir, plan):
        out, _, counts, _ = store_fit(["--graph", heal, "--max-iters", "5"])
    if out["llh_history"] != main_out["llh_history"]:
        raise AssertionError(f"healed history {out['llh_history']}")
    quarantines = [e for e in events_of(tdir) if e["kind"] == "quarantine"]
    if [e["shard"] for e in quarantines] != [1]:
        raise AssertionError(f"quarantine events {quarantines}")
    moved = sorted(os.listdir(os.path.join(heal, QUARANTINE_DIR)))
    # the same corruption refused without healing: `cli.main` raises (a
    # process running it exits non-zero with the traceback)
    t0 = time.perf_counter()
    with telemetry_and_faults(os.path.join(tmp, "noheal_tel"), plan):
        try:
            cli.main(["fit", "--graph", heal, "--k", str(FULL["k"]),
                      "--device", DEVICE, "--max-iters", "1",
                      "--no-self-heal", "--quiet"])
        except ShardCorruption as e:
            refused = e
        else:
            raise AssertionError("--no-self-heal trained on a corrupt shard")
    if refused.shard != 1:
        raise AssertionError(f"ShardCorruption of shard {refused.shard}")
    return {"llh_history": out["llh_history"], "bit_identical_to_main": True,
            "launches": counts, "quarantine": quarantines[0],
            "quarantined_files": moved,
            "graph_stage_s": out["stage_seconds"]["graph"],
            "main_graph_stage_s": main_out["stage_seconds"]["graph"],
            "no_self_heal": {"raised": type(refused).__name__,
                             "seconds": time.perf_counter() - t0,
                             "error": str(refused)[:300]}}


def phase_store_delta(gi, path, tmp, cache):
    """A delta of 1% new edges among existing nodes (default_rng(15)),
    both ends in the first half of the node range, applied with `cli
    ingest --delta` to a copy of store_full's 4-shard cache (later phases
    read the cache itself): the touched shards,
    their share and the re-baked phi; the cache's graph equal to a fresh
    in-memory ingest of text + delta (build_graph) and the touched shards'
    phi to its exact conductance, the untouched shards' blobs byte for
    byte as before; then one cache-fed fit step on the card."""
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.ops.seeding import conductance

    cdir = os.path.join(tmp, "delta.cache")
    shutil.copytree(cache, cdir)
    store = GraphStore.open(cdir)
    rng = np.random.default_rng(DELTA_SEED)
    m = int(DELTA_FRAC * gi.num_edges)
    half = gi.raw_ids[: gi.num_nodes // 2]
    pairs = rng.choice(half, size=(m, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    dpath = os.path.join(tmp, "delta.txt")
    np.savetxt(dpath, pairs, fmt="%d")

    def blobs(s):
        e = store.manifest["shards"][s]
        return [e["indptr"], e["indices"], e["phi"], e["closure"]["ids"]]

    before = {s: [file_sha256(os.path.join(cdir, b)) for b in blobs(s)]
              for s in range(store.num_shards)}
    t0 = time.perf_counter()
    # (the JSON's `seconds` holds the profile's stage buckets, as the JAX
    # entry's does: the wall clock is taken here)
    info = cli_json(["ingest", "--cache-dir", cdir, "--delta", dpath])
    wall = time.perf_counter() - t0
    touched = info["touched_shards"]
    untouched = [s for s in range(store.num_shards) if s not in touched]
    if not touched or not untouched or info["phi_rebaked_shards"] != touched:
        raise AssertionError(f"delta touched {touched}, re-baked "
                             f"{info['phi_rebaked_shards']}")
    after = GraphStore.open(cdir)
    for s in untouched:
        now = [file_sha256(os.path.join(cdir, b)) for b in blobs(s)]
        if now != before[s]:
            raise AssertionError(f"untouched shard {s} changed")
    combined = os.path.join(tmp, "full_plus_delta.txt")
    with open(combined, "wb") as f:
        for p in (path, dpath):
            with open(p, "rb") as src:
                f.write(src.read())
    # a fresh ingest of text + delta: build_graph's (an unbalanced cache's
    # graph is build_graph's on the same text, tests/test_torch_store.py)
    # and its exact conductance (the exact bake's, bit for bit)
    fresh = build_graph(combined)
    if not same_graph(after.load_graph(), fresh):
        raise AssertionError("the delta cache's graph is not a fresh ingest's")
    phi, phi_fresh = after.load_seed_scores(), conductance(fresh, backend="numpy")
    for s in touched:
        lo, hi = after.node_range(s)
        if not np.array_equal(phi.phi[lo:hi], phi_fresh[lo:hi]):
            raise AssertionError(f"re-baked phi of shard {s} is not fresh's")
    out, _, counts, _ = store_fit(["--graph", cdir, "--max-iters", "1"])
    if out["kernel_path"] != "csr_fused" or counts["fused_superstep"] != out["steps"]:
        raise AssertionError(f"delta fit {out['kernel_path']} {counts}")
    return {
        "delta_pairs": int(pairs.shape[0]), "edges_added": info["edges_added"],
        "touched_shards": touched, "touched_frac": info["touched_frac"],
        "touched_rows": info["touched_rows"],
        "phi_rebaked_shards": info["phi_rebaked_shards"],
        "ingest_delta_s": wall, "rss_delta_bytes": info["rss"]["delta_bytes"],
        "files_read": len(info["files_read"]),
        "equal_to_fresh_ingest": True, "untouched_blobs_identical": untouched,
        "fit": {"llh_history": out["llh_history"], "launches": counts,
                "kernel_path": out["kernel_path"]},
    }


# ------------------------------------------------------ serving and refit
SERVE_FIT_ITERS = 1000        # the served dense fit runs to convergence
SERVE_SPARSE_ITERS = 60       # the sparse fit's cap (its steps are ~6x dearer)
SERVE_QUERIES = 4096          # serve_full's mix
# (queries of the mix, passes) a snapshot's `cli serve` runs: the dense
# pass cut from 3 passes to 1 after a proof took 1,278 s of the 1,200
# allowed on a slow host, its dense pass 124 s of that (PERF.md §6, PR
# 21), then to the mix's first 1,024 queries after a proof ran past the
# limit in `dist` (PR 22): the dense pass answered 181 QPS, 23 s a 4,096
SERVE_PASS = {"dense": (1024, 1), "sparse": (SERVE_QUERIES, 3)}
SERVE_SEED = 16
SERVE_ZIPF = 1.1              # members_of: Zipf rank over communities by mass
SERVE_NEW_DEG = (20, 60)      # a new node's neighbour ids
SERVE_CHECK = 64              # suggest answers held against CPU float64
SERVE_LLH_RTOL = 1e-4
SERVE_TIE = 1e-4              # |w - delta| <= SERVE_TIE * max(1, delta)
SERVE_BATCHES = (8, 64)       # fold-in ms per batch at these B
SERVE_SWAP_TOL = 1e-6         # the swap server's fold-in stop (float32)
SERVE_SWAP_ITERS = 500
SERVE_RECOVER_ATOL = 1e-3     # the JAX band (tests/test_serve.py)
SERVE_RECOVER = 16            # existing nodes whose trained rows are recovered
SERVE_CHUNK = 512             # queries per submission of a live stream
REFIT_EDGES = 1000
REFIT_SEED = 17
REFIT_ROUNDS = 3
REFIT_BATCH_RTOL = 1e-4       # one refit batch vs CPU float64, summed LLH
REFIT_ROW_ATOL = 1e-3         # ... and its rows (the JAX recovery band)
REFIT_SUMF_RTOL = 1e-4        # the refit's sumF vs its F's column sums
FOLLOW_SEED = 18
FOLLOW_EDGES = 40             # new edges a delta at parity
FOLLOW_ITERS = 200
FOLLOW_RTOL = 1e-4


def serve_fit(extra):
    """`cli fit` at full width (the default conv_tol: a snapshot carries the
    fit's tolerance as the fold-in's stop), the launch counters zeroed just
    before and read just after, and the publication timed; (out, res,
    final state, counts, publish seconds)."""
    from bigclam_tpu_torch import cli

    args = cli.build_parser().parse_args([
        "fit", "--k", str(FULL["k"]), "--init", "conductance", "--device",
        DEVICE, "--quiet", *extra,
    ])
    timed = {}
    publish = cli.publish_fit

    def timed_publish(*a, **kw):
        t0 = time.perf_counter()
        publish(*a, **kw)
        timed["publish_s"] = time.perf_counter() - t0

    cli.publish_fit = timed_publish
    reset_launch_counts()
    try:
        out, res, state = cli.fit(args)
    finally:
        cli.publish_fit = publish
    counts = launch_counts()
    if not all(math.isfinite(v) for v in out["llh_history"]):
        raise AssertionError(f"non-finite fit: {out['llh_history']}")
    return out, res, state, counts, timed["publish_s"]


def snapshot_cfg(meta: dict):
    """The fit's objective constants as a snapshot stamps them."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.serve.snapshot import FOLDIN_CFG_FIELDS

    return BigClamConfig(num_communities=int(meta["k"]),
                         **{f: meta[f] for f in FOLDIN_CFG_FIELDS})


def phase_serve_publish(gi, tmp, cache):
    """`cli fit --graph <full's 4-shard cache> --k 1000 --publish-dir
    snaps` on the card, run to convergence (SERVE_FIT_ITERS caps it): a
    snapshot as a user serves it, whose zero rows are few; the published F
    equal to the fit's --save-f F bit for bit, fused_superstep launched
    once a step; then the sparse fit at M=64 (SERVE_SPARSE_ITERS steps)
    publishing to snaps_sparse (its F as a dense archive, as the JAX CLI
    publishes it) and its final member lists as a sparse generation
    (publish_snapshot(ids, w)), equal to that F."""
    from bigclam_tpu_torch.serve.snapshot import publish_snapshot
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    card = DEVICE == "cuda"
    n, k = gi.num_nodes, FULL["k"]
    snaps = os.path.join(tmp, "snaps")
    f_npy = os.path.join(tmp, "serve_F.npy")
    out, res, state, counts, pub_s = serve_fit([
        "--graph", cache, "--max-iters", str(SERVE_FIT_ITERS),
        "--publish-dir", snaps, "--save-f", f_npy])
    del state
    if card and (out["kernel_path"] != "csr_fused"
                 or counts["fused_superstep"] != out["steps"]):
        raise AssertionError(f"publish fit {out['kernel_path']} {counts}")
    step, arrays, meta = CheckpointManager(snaps).load_published()
    saved = np.load(f_npy)
    if not (np.array_equal(arrays["F"], saved) and np.array_equal(saved, res.F)):
        raise AssertionError("the published F is not the fit's --save-f F")
    del arrays, saved
    os.remove(f_npy)
    dense = {"generation": out["generation"], "publish_s": pub_s,
             "archive_bytes": os.path.getsize(out["published"]),
             "kernel_path": out["kernel_path"], "launches": counts,
             "steps": out["steps"], "iters": out["iters"],
             "converged": out["iters"] < SERVE_FIT_ITERS,
             "sec_per_iter": out["sec_per_iter"],
             "stage_seconds": out["stage_seconds"],
             "zero_rows": int((res.F.max(axis=1) <= 0).sum()),
             "published_equals_save_f": True}
    snaps_sparse = os.path.join(tmp, "snaps_sparse")
    f_npy = os.path.join(tmp, "serve_F_sparse.npy")
    sout, sres, sstate, scounts, spub_s = serve_fit([
        "--graph", cache, "--max-iters", str(SERVE_SPARSE_ITERS),
        "--representation", "sparse",
        "--sparse-m", str(SPARSE_M), "--publish-dir", snaps_sparse,
        "--save-f", f_npy])
    if card and (sout["kernel_path"] != "sparse_merge_pallas"
                 or not scounts["member_lookup"]):
        raise AssertionError(f"sparse publish fit {sout['kernel_path']} "
                             f"{scounts}")
    _, sarr, smeta = CheckpointManager(snaps_sparse).load_published()
    if not np.array_equal(sarr["F"], np.load(f_npy)):
        raise AssertionError("the sparse fit's published F is not its F")
    del sarr
    os.remove(f_npy)
    ids = sstate.ids[:n].cpu().numpy()
    w = sstate.F[:n].cpu().numpy()
    del sstate
    valid = ids < k
    rows = np.nonzero(valid)[0]
    if not (np.array_equal(sres.F[rows, ids[valid]], w[valid])
            and int(np.count_nonzero(sres.F)) == int(np.count_nonzero(w[valid]))):
        raise AssertionError("the sparse state's member lists are not its F")
    del sres
    t0 = time.perf_counter()
    spath = publish_snapshot(
        snaps_sparse, step=None, ids=ids, w=w, raw_ids=gi.raw_ids,
        num_edges=gi.num_edges, cfg=snapshot_cfg(smeta),
        meta={"llh": sout["llh"], "fit_wall_s": smeta.get("fit_wall_s")})
    member_pub_s = time.perf_counter() - t0
    sparse = {"generation": sout["generation"], "publish_s": spub_s,
              "archive_bytes": os.path.getsize(sout["published"]),
              "member_lists_publish_s": member_pub_s,
              "member_lists_archive_bytes": os.path.getsize(spath),
              "kernel_path": sout["kernel_path"], "launches": scounts,
              "steps": sout["steps"], "iters": sout["iters"],
              "converged": sout["iters"] < SERVE_SPARSE_ITERS,
              "sec_per_iter": sout["sec_per_iter"]}
    return snaps, snaps_sparse, {"dense": dense, "sparse": sparse}


def serve_queries(snap, rng, count: int) -> list:
    """The serve mix: 45% communities_of (uniform u), 45% members_of (Zipf
    rank over communities by mass share), 10% suggest_for, half existing
    nodes and half new nodes given SERVE_NEW_DEG neighbour ids."""
    by_mass = snap.top_mass_communities(snap.k)
    out = []
    kinds = rng.choice(3, size=count, p=[0.45, 0.45, 0.10])
    for kind in kinds:
        if kind == 0:
            out.append({"family": "communities_of",
                        "u": int(rng.choice(snap.raw_ids))})
        elif kind == 1:
            r = int(rng.zipf(SERVE_ZIPF)) - 1
            while r >= snap.k:
                r = int(rng.zipf(SERVE_ZIPF)) - 1
            out.append({"family": "members_of", "c": int(by_mass[r])})
        elif rng.random() < 0.5:
            out.append({"family": "suggest_for",
                        "u": int(rng.choice(snap.raw_ids))})
        else:
            d = int(rng.integers(SERVE_NEW_DEG[0], SERVE_NEW_DEG[1] + 1))
            out.append({"family": "suggest_for", "neighbors": [
                int(v) for v in rng.choice(snap.raw_ids, d, replace=False)]})
    return out


def suggest_items(snap, g, queries) -> list:
    """The fold-in items the server builds for suggest queries."""
    items = []
    for q in queries:
        if "neighbors" in q:
            items.append((np.asarray([snap.row_of(v) for v in q["neighbors"]],
                                     np.int64), None))
        else:
            row = snap.row_of(q["u"])
            lo, hi = int(g.indptr[row]), int(g.indptr[row + 1])
            items.append((g.indices[lo:min(hi, lo + 4096)].astype(np.int64),
                          row))
    return items


def hold_suggests(snap, g, queries, answers) -> dict:
    """Card suggest answers against the port's CPU float64 FoldInEngine on
    the same snapshot: LLH at SERVE_LLH_RTOL, suggested sets equal except
    at near-ties of delta (or of the top-20 cut)."""
    from bigclam_tpu_torch.serve.server import FoldInEngine

    ref = FoldInEngine(snap, device="cpu", dtype=torch.float64).suggest_batch(
        suggest_items(snap, g, queries))
    delta = snap.delta
    band = SERVE_TIE * max(1.0, delta)
    worst, ties, iters_differ = 0.0, 0, 0
    for q, a, b in zip(queries, answers, ref):
        rel = abs(a["llh"] - b["llh"]) / max(abs(b["llh"]), 1e-30)
        worst = max(worst, rel)
        if rel > SERVE_LLH_RTOL:
            raise AssertionError(f"suggest {q}: card llh {a['llh']} vs CPU "
                                 f"float64 {b['llh']}")
        iters_differ += a["iters"] != b["iters"]
        wa, wb = dict(map(tuple, a["suggested"])), dict(map(tuple, b["suggested"]))
        cut = min(min(wa.values(), default=delta), min(wb.values(), default=delta))
        for c in set(wa) ^ set(wb):
            w = wa.get(c, wb.get(c))
            if abs(w - delta) <= band or abs(w - cut) <= band * max(1.0, cut):
                ties += 1
            else:
                raise AssertionError(f"suggest {q}: community {c} (weight {w}) "
                                     f"differs away from a near-tie")
    return {"held": len(queries), "max_llh_rel_err": worst,
            "near_tie_flips": ties, "iters_differ": iters_differ}


def foldin_ms(engine, items) -> dict:
    """Wall ms of one suggest batch (upload, fold-in, answers) at B in
    SERVE_BATCHES: the median of 5 after a warm-up."""
    out = {}
    for b in SERVE_BATCHES:
        batch = items[:b]
        if len(batch) < b:
            raise AssertionError(f"only {len(batch)} suggest items for B={b}")
        engine.suggest_batch(batch)
        times, iters = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            ans = engine.suggest_batch(batch)
            times.append((time.perf_counter() - t0) * 1e3)
            iters = [x["iters"] for x in ans]
        out[f"B{b}"] = {"ms": statistics.median(times), "ms_runs": times,
                        "mean_iters": float(np.mean(iters))}
    return out


def run_cli_serve(snapdir, cache, queries, tmp, tag) -> dict:
    """`cli serve` on the card of the first SERVE_PASS[tag] queries of the
    mix, as many passes as it says, with telemetry and no --results (a
    load test: the answers of members_of run to every member); its stats
    JSON, the fold-in batches and the wall seconds. Exit 0 means no query
    errored."""
    count, passes = SERVE_PASS[tag]
    qfile = os.path.join(tmp, f"serve_queries_{tag}.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries[:count])
    tel = os.path.join(tmp, f"serve_tel_{tag}")
    t0 = time.perf_counter()
    out = cli_json(["serve", "--snapshots", snapdir, "--graph", cache,
                    "--queries", qfile, "--repeat", str(passes),
                    "--device", DEVICE, "--telemetry-dir", tel, "--quiet"])
    wall = time.perf_counter() - t0
    if out["serve_errors"] or out["serve_queries"] != passes * count:
        raise AssertionError(f"serve {tag}: {out}")
    serve = [e for e in events_of(tel) if e["kind"] == "serve"]
    out["foldin_batches"] = sum(1 for e in serve if e.get("n_suggest_for"))
    out["wall_s"] = wall
    return out


class Stream:
    """A live query stream on a MembershipServer: chunks of the mix
    submitted from a thread until stopped; every answer kept."""

    def __init__(self, server, queries):
        import threading

        self.server, self.queries = server, queries
        self.answers, self.chunks, self.error = [], 0, None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            i = 0
            while not self._stop.is_set():
                chunk = [self.queries[(i + j) % len(self.queries)]
                         for j in range(SERVE_CHUNK)]
                i += SERVE_CHUNK
                self.answers.extend(self.server.run_queries(chunk))
                self.chunks += 1
        except Exception as e:   # noqa: BLE001 — re-raised by stop()
            self.error = e

    def wait_chunks(self, n: int, timeout: float = 300.0) -> None:
        t0 = time.monotonic()
        while self.chunks < n:
            if self.error is not None or time.monotonic() - t0 > timeout:
                raise AssertionError(f"stream stalled at {self.chunks} chunks: "
                                     f"{self.error!r}")
            time.sleep(0.01)

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=300)
        if self._thread.is_alive() or self.error is not None:
            raise AssertionError(f"stream did not end: {self.error!r}")
        bad = [a for a in self.answers if "error" in a]
        if bad:
            raise AssertionError(f"stream answers with errors: {bad[:3]}")
        return self.answers


def wait_generation(server, step: int, timeout: float = 300.0) -> float:
    t0 = time.monotonic()
    while server.generation != step:
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"no swap to generation {step} in {timeout} s "
                                 f"(serving {server.generation})")
        time.sleep(0.01)
    return time.monotonic() - t0


def phase_serve_full(gi, tmp, cache, snaps, snaps_sparse):
    """`cli serve` on the card of a mix of SERVE_QUERIES queries
    (default_rng(16)), as SERVE_PASS[tag] cuts it, dense and then sparse:
    p50/p99/QPS, cache hit rate,
    fold-in batches, no error; fold-in ms per batch at B=8 and 64; and an
    in-process server on the same snapshot answering SERVE_CHECK suggests,
    held against the CPU float64 engine; the dense snapshot's zero rows
    and index pairs, and existing nodes' fold-ins recovering their trained
    rows within the JAX band. Sparse also: a hot swap mid-stream (a second
    publish while that server watches every 0.1 s: one swap, nothing
    dropped)."""
    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.serve.server import FoldInEngine, MembershipServer

    store = GraphStore.open(cache, self_heal=False)
    rng = np.random.default_rng(SERVE_SEED)
    qfile = os.path.join(tmp, "serve_queries.jsonl")
    body = {}
    for tag, snapdir in (("dense", snaps), ("sparse", snaps_sparse)):
        t0 = time.perf_counter()
        server = MembershipServer(snapdir, store=store, device=DEVICE,
                                  watch_interval_s=0.1)
        load_s = time.perf_counter() - t0
        try:
            snap = server._snapshot
            if snap.representation != tag:
                raise AssertionError(f"{snapdir} serves {snap.representation}")
            if tag == "dense":
                queries = serve_queries(snap, rng, SERVE_QUERIES)
                with open(qfile, "w") as f:
                    f.writelines(json.dumps(q) + "\n" for q in queries)
                suggests = [q for q in queries if q["family"] == "suggest_for"]
            stats = run_cli_serve(snapdir, cache, queries, tmp, tag)
            held = suggests[:SERVE_CHECK]
            answers = server.run_queries(held)
            engine = FoldInEngine(snap, device=DEVICE)
            iters = [a["iters"] for a in answers]
            body[tag] = {
                "server_load_s": load_s, "generation": snap.step,
                "index_pairs": int(snap.comm_members.size),
                **{key: stats[key] for key in (
                    "serve_p50_s", "serve_p99_s", "serve_qps",
                    "cache_hit_rate", "serve_queries", "serve_errors",
                    "serve_by_family", "batches", "foldin_batches", "wall_s")},
                "held_vs_cpu_float64": hold_suggests(snap, gi, held, answers),
                "iters_per_held_suggest": {"mean": float(np.mean(iters)),
                                           "max": int(np.max(iters))},
                "foldin_ms": foldin_ms(engine, suggest_items(snap, gi,
                                                             suggests)),
            }
            del engine
            if tag == "dense":
                body[tag]["zero_rows"] = int((snap.F.max(axis=1) <= 0).sum())
                body[tag]["recover"] = recover_trained_rows(snap, gi, suggests)
            else:
                body["swap"] = serve_swap(server, snaps_sparse, snap, queries)
        finally:
            server.close()
        del snap
    return body


def recover_trained_rows(snap, gi, suggests) -> dict:
    """An existing node's fold-in recovers its trained row: the first
    SERVE_RECOVER existing nodes of the mix, folded in on the card from
    their own rows against the frozen converged F (stop SERVE_SWAP_TOL,
    at most SERVE_SWAP_ITERS steps), each row within SERVE_RECOVER_ATOL of
    the snapshot's (the JAX band, tests/test_serve.py)."""
    from bigclam_tpu_torch.serve.server import FoldInEngine

    cands = [q for q in suggests if "u" in q][:SERVE_RECOVER]
    eng = FoldInEngine(snap, max_iters=SERVE_SWAP_ITERS,
                       conv_tol=SERVE_SWAP_TOL, device=DEVICE)
    rows, _, iters = eng.fold(suggest_items(snap, gi, cands))
    rows = rows[: len(cands), : snap.k].cpu().double().numpy()
    iters = iters[: len(cands)].cpu().numpy()
    del eng
    trained = np.stack([snap.F[snap.row_of(q["u"])] for q in cands])
    err = np.abs(rows - trained).max(axis=1)
    if err.max() > SERVE_RECOVER_ATOL:
        raise AssertionError(f"fold-in of trained rows: max abs err {err} "
                             f"(nodes {[q['u'] for q in cands]})")
    return {"nodes": len(cands), "max_abs_err": float(err.max()),
            "members": [int(np.count_nonzero(r)) for r in trained],
            "iters": [int(i) for i in iters]}


def serve_swap(server, snapdir, snap, queries) -> dict:
    """serve_full's hot swap on its in-process sparse server: the member
    lists republished as the next generation while a stream runs; one
    swap, no error, nothing dropped."""
    from bigclam_tpu_torch.serve.snapshot import publish_snapshot

    server.reset_stats()
    stream = Stream(server, queries)
    stream.wait_chunks(1)
    before = server.generation
    t0 = time.perf_counter()
    path = publish_snapshot(snapdir, step=None, ids=snap.ids, w=snap.w,
                            raw_ids=snap.raw_ids, num_edges=snap.num_edges,
                            cfg=snapshot_cfg(snap.meta),
                            meta={"llh": snap.meta.get("llh"),
                                  "fit_wall_s": snap.meta.get("fit_wall_s")})
    publish_s = time.perf_counter() - t0
    swap_s = wait_generation(server, before + 1)
    at_swap = stream.chunks
    stream.wait_chunks(at_swap + 1)
    answers = stream.stop()
    submitted = stream.chunks * SERVE_CHUNK
    stats = server.stats()
    if stats["snapshot_swaps"] != 1 or stats["serve_errors"]:
        raise AssertionError(f"swap: {stats['snapshot_swaps']} swaps, "
                             f"{stats['serve_errors']} errors")
    if len(answers) != submitted:
        raise AssertionError(f"swap dropped {submitted - len(answers)} queries")
    iters = [a["iters"] for a in answers if "suggested" in a]
    return {"generation": before + 1, "published": os.path.basename(path),
            "publish_s": publish_s, "swap_after_publish_s": swap_s,
            "snapshot_swaps": stats["snapshot_swaps"],
            "queries_answered": len(answers),
            "chunks_after_swap": stream.chunks - at_swap,
            "serve_errors": stats["serve_errors"],
            "serve_p50_s": stats["serve_p50_s"],
            "serve_p99_s": stats["serve_p99_s"],
            "iters_per_suggest": {"suggests": len(iters),
                                  "mean": float(np.mean(iters)),
                                  "median": float(np.median(iters)),
                                  "max": int(np.max(iters))}}


class RefitSpy:
    """Inside the timed `cli refit`: the first fold-in batch's inputs and
    outputs (the fit that ops.foldin.make_foldin_fit returns, wrapped), the
    rows each commit of that batch's nodes scatters, and the state's sumF
    after the last commit (the model's refit_commit, wrapped)."""

    def __init__(self):
        self.first = None
        self.nodes = self.rows = self.sumF = None

    def __enter__(self):
        from bigclam_tpu_torch.models.bigclam import BigClamModel
        from bigclam_tpu_torch.ops import foldin as fi

        self._make, self._commit = fi.make_foldin_fit, BigClamModel.refit_commit
        spy = self

        def make(cfg, *a, **kw):
            fit = spy._make(cfg, *a, **kw)

            def wrapped(*args):
                out = fit(*args)
                if spy.first is None:      # the refit never writes these
                    spy.first = (cfg, a, kw, args, out)
                return out
            return wrapped

        def commit(model, state, nodes, rows):
            new = spy._commit(model, state, nodes, rows)
            nodes = np.asarray(nodes, np.int64)
            if spy.nodes is None:
                spy.nodes = nodes.copy()
            if np.array_equal(nodes, spy.nodes):
                spy.rows = np.array(rows, copy=True)
            spy.sumF = new.sumF
            return new

        fi.make_foldin_fit, BigClamModel.refit_commit = make, commit
        return self

    def __exit__(self, *exc):
        from bigclam_tpu_torch.models.bigclam import BigClamModel
        from bigclam_tpu_torch.ops import foldin as fi

        fi.make_foldin_fit, BigClamModel.refit_commit = self._make, self._commit


def refit_batch_check(spy, F_new) -> dict:
    """What the timed refit computed, held: its first fold-in batch (the
    model's own float32 state: frozen rows, sumF, masks) against the CPU
    float64 fold-in of the same inputs (LLH summed at REFIT_BATCH_RTOL,
    rows at REFIT_ROW_ATOL); that batch's last committed rows, in the
    published F bit for bit; the state's sumF after the last commit
    against the published F's float64 column sums (REFIT_SUMF_RTOL)."""
    cfg, a, kw, args, out = spy.first
    rc, lc, ic = (t.cpu() for t in out)
    rr, lr, ir = spy._make(cfg, *a, **kw)(*(t.cpu().double() for t in args))
    real = int(spy.nodes.size)
    rc, rr = rc[:real].double().numpy(), rr[:real].numpy()
    lc, lr = lc[:real].double().numpy(), lr[:real].numpy()
    total = abs(lc.sum() - lr.sum()) / abs(lr.sum())
    row_err = float(np.abs(rc - rr).max())
    if total > REFIT_BATCH_RTOL or row_err > REFIT_ROW_ATOL:
        raise AssertionError(f"refit batch LLH {lc.sum()} vs CPU float64 "
                             f"{lr.sum()}, rows max abs err {row_err}")
    k = F_new.shape[1]
    want = np.asarray(spy.rows[:, :k], F_new.dtype)
    if not np.array_equal(F_new[spy.nodes], want):
        raise AssertionError("the published F lacks the refit's committed rows")
    col = F_new.sum(axis=0, dtype=np.float64)
    got = spy.sumF.cpu().double().numpy()[:k]
    drift = float(np.abs(got - col).max() / max(np.abs(col).max(), 1.0))
    if drift > REFIT_SUMF_RTOL:
        raise AssertionError(f"refit sumF drifted {drift} from the F it holds")
    return {"nodes": real, "llh_sum_rel_err": float(total),
            "max_node_llh_rel_err": float(np.max(np.abs(lc - lr)
                                                 / np.abs(lr))),
            "max_row_abs_err": row_err,
            "iters_differ": int((ic[:real].numpy() != ir[:real].numpy()).sum()),
            "committed_rows_published": True, "sumF_rel_drift": drift}


def phase_refit_full(gi, tmp, cache, snaps):
    """A delta of REFIT_EDGES new edges (default_rng(17)) among the first
    cache shard's nodes, applied with `cli ingest --delta` to a copy of the
    cache; `cli refit --graph <copy> --snapshots snaps --delta <file>
    --refit-rounds 3` on the card: rows outside touched + halo equal the
    previous generation bit for bit, the restricted objective never falls
    (unless a detector fired and the JSON says so), the next generation,
    and what the refit itself computed held (refit_batch_check)."""
    import shutil

    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.models import refit as rf
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    store = GraphStore.open(cache)
    lo, hi = store.node_range(0)
    rng = np.random.default_rng(REFIT_SEED)
    pairs = rng.choice(gi.raw_ids[lo:hi], size=(REFIT_EDGES, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    dpath = os.path.join(tmp, "refit_delta.txt")
    np.savetxt(dpath, pairs, fmt="%d")
    copy = os.path.join(tmp, "refit.cache")
    shutil.copytree(cache, copy)
    t0 = time.perf_counter()
    info = cli_json(["ingest", "--cache-dir", copy, "--delta", dpath])
    ingest_s = time.perf_counter() - t0
    cm = CheckpointManager(snaps)
    prev, arrays, _ = cm.load_published()
    F_prev = arrays["F"]
    del arrays
    got = {}
    orig = rf.warm_start_refit

    def spy(*a, **kw):
        got["res"] = orig(*a, **kw)
        return got["res"]

    rf.warm_start_refit = spy
    reset_launch_counts()
    try:
        with RefitSpy() as inside:
            t0 = time.perf_counter()
            out = cli_json(["refit", "--graph", copy, "--snapshots", snaps,
                            "--delta", dpath, "--refit-rounds",
                            str(REFIT_ROUNDS), "--device", DEVICE, "--quiet"])
            wall = time.perf_counter() - t0
    finally:
        rf.warm_start_refit = orig
    counts = launch_counts()
    res = got["res"]
    if out["from_generation"] != prev or out["generation"] != prev + 1:
        raise AssertionError(f"refit published {out['generation']} from "
                             f"{out['from_generation']}, latest was {prev}")
    hist = list(res.history)
    falls = [i for i in range(1, len(hist)) if hist[i] < hist[i - 1]]
    if falls and not out["escalated"]:
        raise AssertionError(f"restricted objective fell: {hist}")
    g1 = GraphStore.open(copy).load_graph()
    touched = rf.touched_rows_from_delta(g1.raw_ids, dpath)
    if touched.size != out["touched"]:
        raise AssertionError(f"refit touched {out['touched']} rows, the delta "
                             f"{touched.size}")
    nodes = rf.expand_halo(g1.indptr, g1.indices, touched, 1)
    _, new, _ = cm.load_published(out["generation"])
    outside = np.ones(g1.num_nodes, bool)
    outside[nodes] = False
    if out["escalated_full_fit"]:
        kept = None        # a full fit moved every row
    elif not np.array_equal(new["F"][outside], F_prev[outside]):
        raise AssertionError("refit changed rows outside touched + halo")
    else:
        kept = int(outside.sum())
    batch = (None if out["escalated_full_fit"]
             else refit_batch_check(inside, new["F"]))
    del new
    return {
        "delta_pairs": int(pairs.shape[0]),
        "delta_edges_added": info["edges_added"],
        "touched_shards": info["touched_shards"], "ingest_delta_s": ingest_s,
        **{key: out[key] for key in (
            "touched", "refit_nodes", "touched_frac", "rounds", "foldin_iters",
            "converged", "escalated", "escalated_full_fit", "refit_wall_s",
            "baseline_fit_wall_s", "refit_cost_ratio", "restricted_llh",
            "from_generation", "generation", "kernel_path")},
        "history": hist, "cli_wall_s": wall, "launches": counts,
        "rows_outside_identical": kept, "batch_vs_cpu_float64": batch,
    }


def follow_fit(cache, snaps, ddir, device, dtype) -> list:
    return ["fit", "--graph", cache, "--k", str(PARITY["k"]), "--max-iters",
            str(FOLLOW_ITERS), "--device", device, "--dtype", dtype,
            "--publish-dir", snaps, "--follow", ddir, "--follow-max", "2",
            "--follow-interval", "0.05", "--refit-rounds", "4", "--quiet"]


def full_llh(F, g) -> float:
    """The float64 LLH of F on graph g (the port's CPU edge sweep)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.ops.objective import EdgeChunks, loglikelihood

    Ft = torch.from_numpy(np.asarray(F, np.float64))
    csr = g.to_device("cpu")
    return float(loglikelihood(Ft, Ft.sum(0), EdgeChunks(csr.src, csr.dst, 1 << 16),
                               BigClamConfig(num_communities=F.shape[1])))


def phase_follow_parity(tmp):
    """At parity size, `cli fit --follow --follow-max 2` on the card in a
    thread while an in-process MembershipServer(watch_interval_s=0.1)
    serves a stream; two delta files dropped in turn: 2 generations, 2
    swaps, no serve error; then the same loop on the CPU in float64 and the
    fit's LLH history and each generation's LLH within FOLLOW_RTOL."""
    import shutil
    import threading

    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.serve.server import MembershipServer
    from bigclam_tpu_torch.serve.snapshot import ServingSnapshot
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    path = os.path.join(tmp, "follow_graph.txt")
    planted_file(PARITY, path)
    cache = os.path.join(tmp, "follow.cache")
    ingest(path, cache, "--shards", "2")
    raw = GraphStore.open(cache).load_graph().raw_ids
    rng = np.random.default_rng(FOLLOW_SEED)
    deltas = []
    for i in range(2):
        p = rng.choice(raw, size=(FOLLOW_EDGES, 2))
        deltas.append(p[p[:, 0] != p[:, 1]])
    runs = {}
    for tag, device, dtype in (("card", DEVICE, "float32"),
                               ("cpu", "cpu", "float64")):
        c = os.path.join(tmp, f"follow_{tag}.cache")
        shutil.copytree(cache, c)
        ddir = os.path.join(tmp, f"follow_{tag}_deltas")
        os.makedirs(ddir)
        snaps = os.path.join(tmp, f"follow_{tag}_snaps")
        runs[tag] = (c, ddir, snaps, follow_fit(c, snaps, ddir, device, dtype))

    def drop(ddir, i):
        tmp_name = os.path.join(ddir, f".d{i}.txt")
        np.savetxt(tmp_name, deltas[i], fmt="%d")
        os.replace(tmp_name, os.path.join(ddir, f"d{i}.txt"))

    c, ddir, snaps, argv = runs["card"]
    result = {}

    def fit_thread():
        try:
            result["out"] = cli_json(argv)
        except Exception as e:   # noqa: BLE001 — re-raised below
            result["error"] = e

    reset_launch_counts()
    t0 = time.perf_counter()
    th = threading.Thread(target=fit_thread, daemon=True)
    th.start()
    while CheckpointManager(snaps).latest() is None:
        if not th.is_alive() or time.perf_counter() - t0 > 600:
            raise AssertionError(f"follow fit published nothing: "
                                 f"{result.get('error')!r}")
        time.sleep(0.02)
    server = MembershipServer(snaps, store=GraphStore.open(c, self_heal=False),
                              watch_interval_s=0.1, budget_s=0.002,
                              device=DEVICE)
    swaps = []
    try:
        stream = Stream(server, serve_queries(
            ServingSnapshot.load(snaps), np.random.default_rng(FOLLOW_SEED),
            1024))
        stream.wait_chunks(1)
        for i in range(2):
            drop(ddir, i)
            swaps.append(wait_generation(server, i + 2))
            stream.wait_chunks(stream.chunks + 1)
        answers = stream.stop()
        stats = server.stats()
    finally:
        server.close()
    th.join(timeout=600)
    if th.is_alive() or "error" in result:
        raise AssertionError(f"follow fit: {result.get('error')!r}")
    card_s = time.perf_counter() - t0
    counts = launch_counts()
    out = result["out"]
    if (out["follow"]["generations"] != 2 or stats["snapshot_swaps"] != 2
            or stats["serve_errors"]):
        raise AssertionError(f"follow: {out['follow']}, swaps "
                             f"{stats['snapshot_swaps']}, errors "
                             f"{stats['serve_errors']}")
    if DEVICE == "cuda" and not counts["fused_superstep"]:
        raise AssertionError(f"follow fit launched no fused_superstep: {counts}")
    c_cpu, ddir_cpu, snaps_cpu, argv_cpu = runs["cpu"]
    for i in range(2):
        drop(ddir_cpu, i)
    ref = cli_json(argv_cpu)
    hist_err = max(abs(a - b) / abs(b) for a, b in
                   zip(out["llh_history"], ref["llh_history"]))
    if (len(out["llh_history"]) != len(ref["llh_history"])
            or hist_err > FOLLOW_RTOL or ref["follow"]["generations"] != 2):
        raise AssertionError(f"follow fit history vs CPU float64: {hist_err}")
    g = GraphStore.open(c).load_graph()
    gens = {}
    for step in (2, 3):
        a = full_llh(ServingSnapshot.load(snaps, step=step).F, g)
        b = full_llh(ServingSnapshot.load(snaps_cpu, step=step).F, g)
        gens[step] = {"card": a, "cpu_float64": b, "rel": abs(a - b) / abs(b)}
        if gens[step]["rel"] > FOLLOW_RTOL:
            raise AssertionError(f"generation {step} LLH {a} vs CPU float64 {b}")
    return {"generations": out["follow"]["generations"],
            "escalations": out["follow"]["escalations"],
            "snapshot_swaps": stats["snapshot_swaps"],
            "serve_errors": stats["serve_errors"],
            "queries_answered": len(answers), "swap_wait_s": swaps,
            "card_seconds": card_s, "fit_iters": out["iters"],
            "llh_history_max_rel_err": hist_err, "generation_llh": gens,
            "launches": counts, "kernel_path": out["kernel_path"]}


QUALITY_ODD_COLS = 24         # random thresholded columns a graph
QUALITY_ODD_DP = 3            # the kick on a repeated-device mesh (hub: n_pad 807)
QUALITY_ODD_SEED = 19
QUALITY = dict(n=2400, k=12, p_in=0.15, seed=7)   # tests/test_quality.py's graph
QUALITY_CYCLES = 8            # the JAX recovery test's restart_cycles
QUALITY_F1 = 0.8              # ... and its gate: F1 >= 0.8, 0.2 above faithful
QUALITY_F1_MARGIN = 0.2
QUALITY_RELAXED = 1.0 - 1e-6  # a pinned cycle clip near full's auto 1 - 5.9e-6
# cycle 0 on the card vs CPU float64, at both clips (PERF.md §6 has the
# measured gaps)
QUALITY_LLH_RTOL = 1e-5
# quality_full's schedule, sized to stay within about three minutes on the
# card (PERF.md §6 has its stage seconds); one repair round, cut from two
# after the slow host's proof of PR 21 (its two rounds took 98 s)
QUALITY_FULL = dict(restart_cycles=6, repair_rounds=1, max_iters=100)
# quality_full's closing card-vs-scipy component pass: the final F's first
# columns (all 1,000 took 10.6 s on the card until PR 22, whose proof ran
# past the 1,200 s limit)
QUALITY_COMPONENT_COLS = 128


def random_columns(g, rng, cols: int) -> np.ndarray:
    """(cols, n) random thresholded columns with the edge cases: an empty
    column, a singleton, every node (isolated ones are singletons), the
    isolated tail alone, and random densities (disconnected pieces)."""
    n = g.num_nodes
    member = rng.random((cols, n)) < rng.uniform(0.0, 0.4, (cols, 1))
    member[0] = False
    member[1] = False
    member[1, int(rng.integers(n))] = True
    member[2] = True
    member[3] = g.degrees == 0
    return member


def min_labels(comps, n: int) -> np.ndarray:
    """The label vector a partition gives: each member its component's
    min id, n for a non-member."""
    lab = np.full(n, n, np.int32)
    for c in comps:
        lab[np.asarray(c)] = min(c)
    return lab


def hold_components(g, member) -> dict:
    """The component pass on the card against the port's CPU pass (labels,
    sizes, internal edges bit for bit), against the scipy oracle (labels
    equal to its partitions' min ids, sizes), and under a patched edge
    budget of 2 columns a batch (bit for bit the one-batch result)."""
    from bigclam_tpu_torch.models.quality import _graph_components
    from bigclam_tpu_torch.ops import components as comp

    n = g.num_nodes
    card_edges = comp.device_edges(g, torch.device(DEVICE))
    card, card_s = wall(comp.column_component_stats, member, *card_edges, n)
    cpu = comp.column_component_stats(member, *comp.device_edges(g, "cpu"), n)
    for what, a, b in zip(("labels", "sizes", "edges"), card, cpu):
        if a.dtype != np.int32 or not np.array_equal(a, b):
            raise AssertionError(f"component {what} on the card differ from the CPU pass")
    for c in range(member.shape[0]):
        comps = _graph_components(np.flatnonzero(member[c]), g.indptr, g.indices)
        if not np.array_equal(card[0][c], min_labels(comps, n)):
            raise AssertionError(f"column {c}: labels differ from scipy's partition")
        for cc in comps:
            if not np.all(card[1][c][cc] == len(cc)):
                raise AssertionError(f"column {c}: component sizes differ")
    saved = comp.EDGE_ELEM_BUDGET
    comp.EDGE_ELEM_BUDGET = 2 * g.num_directed_edges
    try:
        batched = comp.column_component_stats(member, *card_edges, n)
    finally:
        comp.EDGE_ELEM_BUDGET = saved
    if not all(np.array_equal(a, b) for a, b in zip(card, batched)):
        raise AssertionError("two columns a batch differ from one batch")
    return {"columns": int(member.shape[0]), "n": n,
            "components": int(sum(len(np.unique(l[l < n])) for l in card[0])),
            "card_s": card_s, "batches_patched": -(-member.shape[0] // 2)}


def hold_kick(model, n: int, k: int) -> dict:
    """The device kick (DeviceNoise + kick_F), scatter edits and clear_col
    on the model's layout leave every padding row and column exactly zero,
    and the columns past kick_cols as they were."""
    from bigclam_tpu_torch.models import quality as q

    kc = k - 3
    noise = q.DeviceNoise(QUALITY_ODD_SEED, 3)
    dev = torch.device(DEVICE)
    u = noise(0, (n, kc), 0.01, torch.float32, dev)
    if not torch.equal(u, noise(0, (n, kc), 0.01, torch.float32, dev)):
        raise AssertionError("the device noise is not deterministic")
    st = model.init_state(np.ones((n, k)))
    F = q.kick_F(st.F, u, n, kc, 0.0, 1000.0)
    full = torch.cat([f.cpu() for f in q._parts(F)]).numpy()
    parts = [f.clone() for f in q._parts(F)]
    q.scatter_set_(parts, np.array([0, n - 1, model.n_pad + 5]),
                   np.array([1, 2, 0]), 9.0)
    q.clear_col_(parts, 4)
    edited = torch.cat([p.cpu() for p in parts]).numpy()
    ok = (full.shape == (model.n_pad, model.k_pad)
          and not full[n:].any() and not full[:, k:].any()
          and np.all(full[:n, kc:k] == 1.0)
          and np.all((full[:n, :kc] >= 1.0) & (full[:n, :kc] < 1.01))
          and not edited[n:].any() and not edited[:, k:].any()
          and not edited[:, 4].any() and np.count_nonzero(edited == 9.0) == 2)
    if not ok:
        raise AssertionError(f"{type(model).__name__}: the kick or the edits "
                             "touched padding")
    return {"n": n, "n_pad": model.n_pad, "k": k, "k_pad": model.k_pad,
            "kick_cols": kc, "shards": len(q._parts(F)), "padding_zero": True}


def phase_quality_odd() -> dict:
    """The device component pass and the device kick on small graphs."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.parallel import ShardedBigClamModel

    rng = np.random.default_rng(QUALITY_ODD_SEED)
    out = {}
    hub = hub_graph()
    for name, g in (("odd", odd_graph()), ("hub", hub)):
        out[name] = hold_components(g, random_columns(g, rng, QUALITY_ODD_COLS))
    k = ODD["k"]
    cfg = BigClamConfig(num_communities=k)
    out["kick_dense"] = hold_kick(BigClamModel(hub, cfg, device=DEVICE),
                                  hub.num_nodes, k)
    mesh = ShardedBigClamModel(hub, cfg, repeated_mesh(QUALITY_ODD_DP),
                               balance=True)
    out["kick_mesh"] = hold_kick(mesh, hub.num_nodes, k)
    return out


def cli_steps(metrics_path) -> int:
    """Steps a fit (or schedule) evaluated: the --metrics records."""
    with open(metrics_path) as f:
        return sum(1 for line in f if line.strip())


@contextlib.contextmanager
def omp_lo_spy():
    """The omp_lo every fused_superstep launch takes (the card only)."""
    from bigclam_tpu_torch.ops import fused

    seen = []
    orig = fused.kernel_constants

    def spy(cfg):
        c = orig(cfg)
        seen.append(c["omp_lo"])
        return c

    fused.kernel_constants = spy
    try:
        yield seen
    finally:
        fused.kernel_constants = orig


def quality_f1(F, g, truth) -> float:
    from bigclam_tpu_torch.evaluation import avg_f1
    from bigclam_tpu_torch.ops.extraction import extract_communities

    return avg_f1(list(extract_communities(np.asarray(F), g).values()), truth)


def phase_quality_parity(tmp) -> dict:
    """tests/test_quality.py's graph on the card: the faithful fit, `cli fit
    --quality` and `--quality --device-annealing` on csr_fused (F1 gate,
    launches = steps, kept LLH never falls); cycle 0 at the auto and at a
    pinned relaxed clip against the port's CPU float64 run from the same
    kicked F, with the kernels' omp_lo; the device schedule run twice."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models import quality as q
    from bigclam_tpu_torch.models.agm import sample_planted_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    p = QUALITY
    g, truth = sample_planted_graph(p["n"], p["k"], p_in=p["p_in"],
                                    rng=np.random.default_rng(p["seed"]))
    path = os.path.join(tmp, "quality_graph.txt")
    np.savetxt(path, np.stack([g.src, g.dst], axis=1)[g.src < g.dst], fmt="%d")
    base = ["--graph", path, "--k", str(p["k"]), "--device", DEVICE]
    runs = {}
    for name, extra in (
        ("faithful", []),
        ("quality", ["--quality", "--restart-cycles", str(QUALITY_CYCLES)]),
        ("device_annealing", ["--quality", "--device-annealing",
                              "--restart-cycles", str(QUALITY_CYCLES)]),
    ):
        metrics = os.path.join(tmp, f"quality_{name}.jsonl")
        reset_launch_counts()
        out, res, qres = cli.fit(fit_args(base + extra + ["--metrics", metrics]))
        counts = launch_counts()
        steps = cli_steps(metrics)
        if out["n"] != g.num_nodes or not np.isfinite(res.F).all():
            raise AssertionError(f"{name}: a malformed fit")
        if DEVICE == "cuda" and (out["kernel_path"] != "csr_fused"
                                 or counts["fused_superstep"] != steps):
            raise AssertionError(f"{name}: path {out['kernel_path']}, "
                                 f"{counts['fused_superstep']} launches for {steps} steps")
        run = {"f1": quality_f1(res.F, g, truth), "llh": res.llh,
               "steps": steps, "launches": counts["fused_superstep"],
               "seconds": out["stage_seconds"]["fit"],
               "kernel_path": out["kernel_path"]}
        if "quality_cycles" in out:          # qres: the QualityResult
            kept = np.maximum.accumulate(qres.cycles_llh)
            if res.llh < kept[-1] - abs(kept[-1]) * 1e-6:
                raise AssertionError(f"{name}: the kept LLH fell: {res.llh} < {kept[-1]}")
            run.update(cycles=qres.num_cycles, total_iters=qres.total_iters,
                       repairs=qres.num_repairs, cycles_llh=list(qres.cycles_llh),
                       stages=qres.stages)
        runs[name] = run
    for name in ("quality", "device_annealing"):
        f1, f1_faithful = runs[name]["f1"], runs["faithful"]["f1"]
        if f1 < QUALITY_F1 or f1 <= f1_faithful + QUALITY_F1_MARGIN:
            raise AssertionError(f"{name}: F1 {f1} vs faithful {f1_faithful}")
    # cycle 0 on the card against CPU float64, at the auto clip and pinned
    cfg = BigClamConfig(num_communities=p["k"], quality_mode=True,
                        restart_cycles=1, quality_repair=False)
    F0 = cli.init_F(g, cfg, "conductance")
    cycle0 = {}
    for tag, max_p in (("auto", None), ("relaxed", QUALITY_RELAXED)):
        c = cfg.replace(quality_max_p=max_p)
        model = BigClamModel(g, c, device=DEVICE)
        max_p_q = q._relax_params(model, g.num_nodes)[0]
        with omp_lo_spy() as seen:
            card = q.fit_quality(model, F0)
            during = sorted(set(seen))
            seen.clear()
            model.fit_state(model.init_state(F0))
            after = sorted(set(seen))
        cpu = q.fit_quality(BigClamModel(g, c.replace(dtype="float64"),
                                         device="cpu"), F0)
        a, b = card.fit.llh_history, cpu.fit.llh_history
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        if rel > QUALITY_LLH_RTOL or not all(map(math.isfinite, a)):
            raise AssertionError(f"cycle 0 ({tag}): card {a} vs cpu float64 {b}")
        want = [float(np.float32(1.0 - max_p_q))]
        parity = [float(np.float32(1.0 - c.max_p))]
        if DEVICE == "cuda" and (during != want or after != parity):
            raise AssertionError(f"omp_lo {during} during, {after} after; "
                                 f"want {want}, {parity}")
        cycle0[tag] = {"max_p": max_p_q, "steps_card": len(a),
                       "steps_cpu": len(b), "max_rel": rel,
                       "omp_lo_during": during, "omp_lo_after": after}
    # the device schedule twice: bit for bit for a seed
    cfg2 = cfg.replace(restart_cycles=2, quality_repair=True)
    r1 = q.fit_quality_device(BigClamModel(g, cfg2, device=DEVICE), F0)
    r2 = q.fit_quality_device(BigClamModel(g, cfg2, device=DEVICE), F0)
    repeat = bool(np.array_equal(r1.fit.F, r2.fit.F)
                  and r1.cycles_llh == r2.cycles_llh)
    return {"n": g.num_nodes, "k": p["k"], "runs": runs, "cycle0": cycle0,
            "device_schedule_repeats_bit_for_bit": repeat}


def phase_quality_full(gi, F0, main_out, main_zero_rows) -> dict:
    """`full` through fit_quality_device from main's conductance F0 on
    csr_fused (QUALITY_FULL's schedule): stage seconds, the transfer
    counts, steps and seconds a step beside main's, peak device memory,
    the zero rows and the LLH before and after; the component pass on the
    card beside scipy on the final F's first QUALITY_COMPONENT_COLS
    columns, labels equal."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models import quality as q
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.ops import components as comp
    from bigclam_tpu_torch.ops.extraction import delta_threshold

    n, k = gi.num_nodes, FULL["k"]
    cfg = BigClamConfig(num_communities=k, quality_mode=True, **QUALITY_FULL)
    model = BigClamModel(gi, cfg, device=DEVICE)
    max_p_q, eps = q._relax_params(model, n)
    fits = []                           # (steps, seconds) of each fit_state
    orig_fit_state = model.fit_state

    def timed_fit_state(state, callback=None, **kw):
        steps = [0]

        def cb(it, llh):
            steps[0] += 1

        t0 = time.perf_counter()
        res = orig_fit_state(state, callback=cb, **kw)
        fits.append((steps[0], time.perf_counter() - t0))
        return res

    model.fit_state = timed_fit_state
    passes = []                         # the component passes' devices
    orig_stats, orig_host = comp.column_component_stats, q._column_atoms_host

    def stats_spy(member_cols, src_dev, *a, **kw):
        passes.append(src_dev.device.type)
        return orig_stats(member_cols, src_dev, *a, **kw)

    def host_spy(*a, **kw):
        passes.append("scipy")
        return orig_host(*a, **kw)

    comp.column_component_stats, q._column_atoms_host = stats_spy, host_spy
    try:
        if DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        reset_launch_counts()
        with omp_lo_spy() as seen:
            qres, wall_s = wall(q.fit_quality_device, model, F0)
        counts = launch_counts()
        omp = sorted(set(seen))
        peak = (torch.cuda.max_memory_allocated() - before
                if DEVICE == "cuda" else 0)
    finally:
        comp.column_component_stats, q._column_atoms_host = orig_stats, orig_host
        model.fit_state = orig_fit_state
    F = qres.fit.F
    st = qres.stages
    steps = sum(s for s, _ in fits)
    rounds = st["counts"].get("repair_rounds", 0)
    if F.shape != (n, k) or not np.isfinite(F).all():
        raise AssertionError("quality_full: a malformed F")
    if (st["counts"]["f_host_uploads"] != 1
            or st["counts"]["f_device_fetches"] > rounds + 1):
        raise AssertionError(f"quality_full transfers: {st['counts']}")
    if model.cfg != cfg:
        raise AssertionError("quality_full: the parity cfg did not come back")
    if DEVICE == "cuda":
        if counts["fused_superstep"] != steps or not steps:
            raise AssertionError(f"{counts['fused_superstep']} launches for {steps} steps")
        if omp != [float(np.float32(1.0 - max_p_q))]:
            raise AssertionError(f"omp_lo during the schedule: {omp}")
        if "scipy" in passes or any(d != "cuda" for d in passes):
            raise AssertionError(f"a component pass left the card: {passes}")
    zero_after = int((~F.any(axis=1)).sum())
    # the final F's LLH under the parity clip, as main's LLH is
    model.cfg = cfg.replace(max_iters=0)
    model.rebuild_step()
    _, llh_parity, _, _ = model.fit_state(model.init_state(F))
    model.cfg = cfg
    model.rebuild_step()
    del model
    # the component pass on the card beside scipy, on the final columns
    member = (F[:, :QUALITY_COMPONENT_COLS]
              >= delta_threshold(gi.num_nodes, gi.num_edges)).T
    edges = comp.device_edges(gi, torch.device(DEVICE))
    (labels, _, _), card_s = wall(comp.column_component_stats, member, *edges, n)
    t0 = time.perf_counter()
    comps = [q._graph_components(np.flatnonzero(m), gi.indptr, gi.indices)
             for m in member]
    scipy_s = time.perf_counter() - t0
    for c, cc in enumerate(comps):
        if not np.array_equal(labels[c], min_labels(cc, n)):
            raise AssertionError(f"quality_full column {c}: labels differ from scipy")
    anneal = fits[:qres.num_cycles]
    return {
        "schedule": QUALITY_FULL, "max_p": max_p_q, "eps": eps,
        "schedule_seconds": wall_s, "stages": st, "cycles": qres.num_cycles,
        "cycles_llh": list(qres.cycles_llh), "total_iters": qres.total_iters,
        "repairs": qres.num_repairs, "steps": steps,
        "launches": counts["fused_superstep"],
        "fits": [{"steps": s, "seconds": t} for s, t in fits],
        "sec_per_step": sum(t for _, t in fits) / max(steps, 1),
        "sec_per_step_anneal": (sum(t for _, t in anneal)
                                / max(sum(s for s, _ in anneal), 1)),
        "main_sec_per_iter": main_out["sec_per_iter"],
        "omp_lo": omp, "peak_device_gb": peak / 1e9,
        "component_passes": passes,
        "zero_rows_before": main_zero_rows, "zero_rows_after": zero_after,
        "llh_before": main_out["llh"], "llh_after": qres.fit.llh,
        "llh_after_parity_clip": llh_parity,
        "components": {"columns": int(member.shape[0]),
                       "nonempty": int(member.any(axis=1).sum()),
                       "card_s": card_s, "scipy_s": scipy_s,
                       "labels_equal": True},
    }


# --- the 2D edge-block partition ----------------------------------------------

# twod_odd's cases: (graph, (rows, cols), K); on one card the positions
# share it. C = 1 flat runs kernel A, C > 1 flat #8/#9 and the epilogue,
# K = 1,100 the K-blocked windows (the node pass at C = 1, the neighbour
# sums and the epilogue at C > 1)
TWOD_ODD_CASES = (("odd", (2, 2), ODD["k"]), ("odd", (3, 1), ODD["k"]),
                  ("hub", (2, 2), 1000), ("hub", (3, 1), 1100),
                  ("hub", (2, 2), 1100))
TWOD_ODD_CAP_STEPS = 4        # the closure_grad_cap = 1 build's steps
TWOD_ITERS = 4                # twod_full / twod_xlk fits: steps 0..4
TWOD_MESH = 4                 # `--mesh 4,1`: four positions on one card
TWOD_STORE_ITERS = 2
TWOD_CHECKS = ("fused_superstep", "ring_grad_phase", "ring_cand_phase",
               "armijo_tail_select", *K_BLOCKED)


def twod_grid(rows: int, cols: int):
    """A (rows, cols) 2D mesh on one card (the device repeated)."""
    from bigclam_tpu_torch.parallel import make_mesh_2d

    return make_mesh_2d((rows, cols), [torch.device(DEVICE)] * (rows * cols))


def twod_plain_step_inputs(model, F, closure, F_row, sumF):
    """A 2D step's intermediates from the plain versions in float64 (F,
    closure tables and source rows given in float32): per position the row
    group's folded gradient (#8 plain from zero, summed over the group),
    and the own block's gradient, node LLH and candidate sums (#9 plain,
    scattered) — the epilogue's inputs."""
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.ops.objective import node_tail

    C, p = model.C, model.p
    n_blk = F[0].shape[0]
    s = len(model.cfg.step_candidates)
    sumF64 = sumF.double()
    gn, ln = [], []
    for b in range(p):
        fr = F_row[b].double()
        g_, l_ = torch.zeros_like(fr), fr.new_zeros(fr.shape[0])
        rk.ring_grad_phase_plain(fr, closure[b].double(), model.block_csr[b], g_, l_,
                                 model.cfg)
        gn.append(g_)
        ln.append(l_)
    grads, own = [], []
    for b in range(p):
        i, j = divmod(b, C)
        group = range(i * C, (i + 1) * C)
        total = sum(gn[c] for c in group)
        grads.append(total - sumF64[None, :] + F_row[b].double())
    cbs = []
    for b in range(p):
        cb = torch.zeros((s, F_row[b].shape[0]), dtype=torch.float64, device=F[b].device)
        rk.ring_cand_phase_plain(F_row[b].double(), grads[b].float().double(),
                                 closure[b].double(), model.block_csr[b], cb, model.cfg)
        cbs.append(cb)
    for b in range(p):
        i, j = divmod(b, C)
        group = range(i * C, (i + 1) * C)
        sl = slice(j * n_blk, (j + 1) * n_blk)
        ln_own = sum(ln[c][sl] for c in group)
        cand_own = sum(cbs[c][:, sl] for c in group)
        node_llh = ln_own + node_tail(F[b].double(), sumF64)
        own.append((grads[b][sl], node_llh, cand_own))
    return grads, own


def twod_odd_case(checks, g, shape, k: int, tag: str) -> dict:
    """One 2D layout on the card at K, random F (row 7 zero): each kernel
    the path runs against its plain version on the closure-table inputs
    (kernel A with the closure table as its destination rows; #8 and #9
    from random accumulators, F_rot the closure table; the K-blocked
    windows through compare_kb_dst, the node pass or the neighbour sums;
    the epilogue on the own block's inputs of a plain step), and at C > 1
    closure_grad_allreduce on the kernels' partials bit for bit the dense
    psum in every row a position touched or owns."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.ops import fused
    from bigclam_tpu_torch.ops import kblocked as kb
    from bigclam_tpu_torch.ops import ring_kernels as rk
    from bigclam_tpu_torch.parallel import TwoDShardedBigClamModel
    from bigclam_tpu_torch.parallel import twod
    from bigclam_tpu_torch.parallel.sharded import psum
    from bigclam_tpu_torch.parallel.sparse_collectives import closure_grad_allreduce

    R, C = shape
    cfg = BigClamConfig(num_communities=k, partition="2d", replica_cols=C)
    model = TwoDShardedBigClamModel(g, cfg, twod_grid(R, C))
    kc, p, n_blk = model.kc, model.p, model.n_pad // model.p
    rng = np.random.default_rng(k + 10 * C)
    F_host = np.zeros((model.n_pad, model.k_pad))
    F_host[: g.num_nodes, :k] = rng.uniform(0.0, 1.0, (g.num_nodes, k))
    F_host[7] = 0.0
    F = list(model._shard_state(F_host).F)
    sumF = F[0].new_zeros(model.k_pad)
    for f in F:
        sumF = sumF + f.sum(dim=0)
    F_row = twod.row_gather(F, model.rows_grid)
    closure = twod.closure_exchange(F, model._send_idx, model.rows_grid)
    body = {"mesh": f"{R}x{C}", "k": k, "kc": kc, "k_pad": model.k_pad,
            "path": model.engaged_path, "closure_cap": model._twod_cap,
            "block_edges": [c.num_directed_edges for c in model.block_csr]}
    sumF64 = sumF.double()
    if C > 1:
        grads, own = twod_plain_step_inputs(model, F, closure, F_row, sumF)
    if kc:
        for b, csr in enumerate(model.block_csr):
            compare_kb_dst(checks, f"{tag}_b{b}", F_row[b], csr, closure[b], sumF, cfg, kc)
            fr64, cl64 = F_row[b].double(), closure[b].double()
            x = kb.edge_dots_windows(fr64, csr, kc, cl64, plain=True)
            if C == 1:
                g_, ln_, xc = kb.grad_cand_windows(x, fr64, sumF64, csr, cfg, kc, True,
                                                   cl64, plain=True)
                check_node_pass(checks["cand_from_x"], f"{tag}_b{b}", xc.float(), F[b],
                                sumF, g_.float(), ln_.float(), csr, cfg)
                continue
            xc = torch.zeros((len(cfg.step_candidates), csr.num_directed_edges),
                             dtype=torch.float64, device=x.device)
            gw = torch.empty_like(fr64)
            for col0 in range(0, model.k_pad, kc):
                kb.grad_from_x_kb_plain(x, fr64, sumF64, csr, col0, kc, cfg, True,
                                        gw[:, col0 : col0 + kc], cl64)
                kb.cand_dots_kb_plain(fr64, gw[:, col0 : col0 + kc], csr, col0, kc,
                                      cfg, xc, cl64)
            out_k = kb.cand_nbr_from_x(xc.float(), csr, cfg)
            torch.cuda.synchronize()
            checks["cand_from_x"].close(f"{tag}_b{b}_cand_nbr", out_k,
                                        kb.cand_nbr_from_x_plain(xc, csr, cfg))
    elif C == 1:
        c = checks["fused_superstep"]
        for b, csr in enumerate(model.block_csr):
            grad_p, llh_p, cand_p, thr_p = fused.acceptance_inputs_plain(
                F[b].double(), sumF64, csr, cfg, closure[b].double())
            Fn_k, g_k, l_k, ok_k = fused.fused_superstep(F[b], sumF, csr, cfg, closure[b])
            torch.cuda.synchronize()
            c.close(f"{tag}_grad", g_k, grad_p)
            c.close(f"{tag}_node_llh", l_k, llh_p)
            c.ok_mask(ok_k, cand_p >= thr_p, cand_p, thr_p, f"{tag}_ok")
            c.close(f"{tag}_F_new", Fn_k, fused.project_accepted(F[b].double(), grad_p,
                                                                  ok_k, cfg))
    else:
        s = len(cfg.step_candidates)
        gn_k = []
        torch.manual_seed(k)
        for b, csr in enumerate(model.block_csr):
            n = F_row[b].shape[0]
            acc0 = (torch.rand((n, model.k_pad), device=DEVICE),
                    torch.rand(n, device=DEVICE), torch.rand((s, n), device=DEVICE))
            kern = [a.clone() for a in acc0]
            plain = [a.double() for a in acc0]
            g32 = grads[b].float()
            rk.ring_grad_phase(F_row[b], closure[b], csr, kern[0], kern[1], cfg)
            rk.ring_grad_phase_plain(F_row[b].double(), closure[b].double(), csr,
                                     plain[0], plain[1], cfg)
            rk.ring_cand_phase(F_row[b], g32, closure[b], csr, kern[2], cfg)
            rk.ring_cand_phase_plain(F_row[b].double(), g32.double(), closure[b].double(),
                                     csr, plain[2], cfg)
            torch.cuda.synchronize()
            checks["ring_grad_phase"].close(f"{tag}_gn", kern[0], plain[0])
            checks["ring_grad_phase"].close(f"{tag}_ln", kern[1], plain[1])
            checks["ring_cand_phase"].close(f"{tag}_cb", kern[2], plain[2])
            gz, lz = torch.zeros_like(F_row[b]), F_row[b].new_zeros(n)
            gn_k.append(rk.ring_grad_phase(F_row[b], closure[b], csr, gz, lz, cfg)[0])
    if C > 1:
        for b in range(p):
            g_own, node_llh, cand_own = own[b]
            check_epilogue(checks["armijo_tail_select"], f"{tag}_b{b}", F[b], sumF,
                           g_own.float(), node_llh.float(), cand_own.float(), cfg)
        if not kc:
            tabs, rows_checked = model._grad_tabs, 0
            for i, row in enumerate(model.rows_grid):
                group = list(range(i * C, (i + 1) * C))
                out, cnt, fb = closure_grad_allreduce(
                    [gn_k[b] for b in group], [tabs["out"][b] for b in group],
                    [tabs["in"][b] for b in group], [tabs["count"][b] for b in group],
                    tabs["cap"], list(row), "s", "c")
                want = psum([gn_k[b] for b in group], list(row))[0]
                if int(fb):
                    raise AssertionError(f"{tag}: the auto cap fell back")
                for j, b in enumerate(group):
                    rows = torch.unique(model.block_csr[b].src)
                    own_rows = torch.arange(j * n_blk, (j + 1) * n_blk, device=rows.device)
                    rows = torch.unique(torch.cat([rows, own_rows]))
                    if not torch.equal(out[j][rows], want[rows]):
                        raise AssertionError(f"{tag}: closure_grad_allreduce differs "
                                             "from the dense psum")
                    rows_checked += int(rows.numel())
            body["closure_grad_allreduce"] = {
                "bit_equal": True, "rows_checked": rows_checked,
                "grad_cap": model._grad_cap, "pair_max": model._grad_pair_max}
    return body


def twod_cap1(g) -> dict:
    """The odd graph on (2, 2) at K = 37: a closure_grad_cap = 1 build falls
    back to the dense psum on every step (the counters say so each step),
    and its history and F are the dense build's bit for bit."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.parallel import TwoDShardedBigClamModel

    cfg = BigClamConfig(num_communities=ODD["k"], partition="2d", replica_cols=2)
    # small weights: at 0.3 and above every row collapses to zero in one
    # step on this graph, and any two builds then agree trivially
    F0 = np.random.default_rng(23).uniform(0.0, 0.1, (g.num_nodes, ODD["k"]))
    runs = {}
    for name, c in (("cap1", cfg.replace(closure_grad_cap=1)),
                    ("dense", cfg.replace(grad_exchange="dense"))):
        model = TwoDShardedBigClamModel(g, c, twod_grid(2, 2))
        st, hist, comm = model.init_state(F0), [], []
        for _ in range(TWOD_ODD_CAP_STEPS):
            st = model._step(st)
            hist.append(float(st.llh))
            comm.append(model.last_comm(st))
        runs[name] = (hist, model.extract_F(st), comm, model)
    hist, F, comm, model = runs["cap1"]
    if not all(fb and ids > 1 for ids, fb in comm):
        raise AssertionError(f"cap 1 did not fall back every step: {comm}")
    if hist != runs["dense"][0] or not np.array_equal(F, runs["dense"][1]):
        raise AssertionError("the cap-1 fallback differs from the dense build")
    return {"steps": TWOD_ODD_CAP_STEPS, "comm": comm, "pair_max": model._grad_pair_max,
            "llh_history": hist, "bit_equal_dense": True}


def phase_twod_odd() -> tuple:
    """twod_odd_case over TWOD_ODD_CASES (the odd and hub graphs), then the
    cap-1 fallback (twod_cap1)."""
    checks = {n: Check(n) for n in TWOD_CHECKS}
    graphs = {"odd": odd_graph(), "hub": hub_graph()}
    out = {}
    for gname, shape, k in TWOD_ODD_CASES:
        tag = f"{gname}_{shape[0]}x{shape[1]}_k{k}"
        out[tag] = twod_odd_case(checks, graphs[gname], shape, k, tag)
    out["cap1"] = twod_cap1(graphs["odd"])
    out["kernels"] = {n: c.parts for n, c in checks.items() if c.parts}
    return checks, out


def twod_launches_want(counts, p: int, cols: int, n_kb: int, steps: int) -> dict:
    """The launches `steps` 2D steps on p positions imply: per position and
    step, at C = 1 kernel A (flat) or each window kernel once a window and
    the node pass; at C > 1 #8, #9 (flat) or the window kernels and the
    neighbour sums (K-blocked), and the epilogue."""
    want = dict.fromkeys(counts, 0)
    per = p * steps
    if n_kb:
        want.update(edge_dots_kb=per * n_kb, grad_from_x=per * n_kb,
                    cand_dots_kb=per * n_kb)
        if cols == 1:
            want["cand_select_from_x"] = per
        else:
            want.update(cand_from_x=per, armijo_tail_select=per)
    elif cols == 1:
        want["fused_superstep"] = per
    else:
        want.update(ring_grad_phase=per, ring_cand_phase=per, armijo_tail_select=per)
    return want


def twod_run(g, path, k, cols, want_path, n_kb, ref_hist, ref_name) -> tuple:
    """`cli fit --mesh 4,1 --partition 2d --replica-cols cols` on the card
    under the comms counter, the launch counters zeroed around it: the path,
    the launches twod_launches_want implies, the LLH within LLH_RTOL of
    `ref_hist`, the counted collective bytes a step equal to the model's
    (`comms_bytes_per_step`), the peak beside the modeled bytes (check_peak)
    and the exchange's counters. Returns (history, body)."""
    from bigclam_tpu_torch.obs import comms

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with comms.counting() as ctr:
        out, _, counts, state = run_path(g, path, k, [
            "--max-iters", str(TWOD_ITERS), "--mesh", f"{TWOD_MESH},1",
            "--partition", "2d", "--replica-cols", str(cols)])
    peak = torch.cuda.max_memory_allocated() - base
    rows = TWOD_MESH // cols
    if (out["kernel_path"], out["mesh"]) != (want_path, f"{rows}x{cols}"):
        raise AssertionError(f"ran {out['kernel_path']} on {out['mesh']}, want "
                             f"{want_path} on {rows}x{cols}")
    steps = out["steps"]
    want = twod_launches_want(counts, TWOD_MESH, cols, n_kb, steps)
    if counts != want:
        raise AssertionError(f"{want_path} {rows}x{cols} launches {counts}, want {want}")
    hist = out["llh_history"]
    rel = llh_rel(hist, ref_hist[: len(hist)])
    if rel > LLH_RTOL:
        raise AssertionError(f"{want_path} {rows}x{cols} LLH {hist} vs {ref_name} "
                             f"{ref_hist}")
    counted = {s: b / steps for s, b in ctr.bytes.items() if s.startswith("twod/")}
    counted_total = round(sum(counted.values()), 1)
    if abs(counted_total - out["comms_bytes_per_step"]) > 1.0:
        raise AssertionError(f"counted {counted_total} B a step, modeled "
                             f"{out['comms_bytes_per_step']}")
    modeled = out["hbm_modeled_bytes"]
    ids, fell_back = (0, False)
    if getattr(state, "comm_ids", None) is not None:
        ids, fell_back = int(state.comm_ids), bool(int(state.comm_dense))
    return hist, {
        "kernel_path": want_path, "mesh": out["mesh"], "grad_exchange":
        out["grad_exchange"], "replica_cols": out["replica_cols"],
        "llh_history": hist, f"max_rel_vs_{ref_name}": rel, "steps": steps,
        "sec_per_iter": out["sec_per_iter"], "launches": counts,
        "comms_bytes_per_step_counted": counted_total,
        "comms_bytes_per_step_modeled": out["comms_bytes_per_step"],
        "counted_sites": counted, "exchanged_ids": ids, "fell_back": fell_back,
        "peak_gb_measured": peak / 1e9, "peak_gb_modeled": modeled / 1e9,
        "peak_modeled_over_measured": check_peak(f"{want_path} {rows}x{cols}", peak,
                                                 modeled, 1),
        "stage_seconds": out["stage_seconds"],
    }


def phase_twod_full(g, path, main_hist) -> tuple:
    """`full` through `cli fit --mesh 4,1` (the 1D all-gather, csr_fused)
    and `--partition 2d` at --replica-cols 1 (csr_fused_2d on kernel A, its
    history bit for bit the 1D one) and 2 (csr_fused_2d on #8/#9 with the
    closure exchange, within LLH_RTOL of main's), each twod_run's numbers
    beside the all-gather's seconds a step."""
    out, counts_by = {}, {}
    ag, _, ag_counts, _ = run_path(g, path, FULL["k"], [
        "--max-iters", str(TWOD_ITERS), "--mesh", f"{TWOD_MESH},1"])
    if ag["kernel_path"] != "csr_fused":
        raise AssertionError(f"the all-gather ran {ag['kernel_path']}")
    out["allgather_4x1"] = {"llh_history": ag["llh_history"],
                            "sec_per_iter": ag["sec_per_iter"], "launches": ag_counts}
    for cols in (1, 2):
        hist, body = twod_run(g, path, FULL["k"], cols, "csr_fused_2d", 0,
                              main_hist, "main")
        if cols == 1 and hist != ag["llh_history"]:
            raise AssertionError(f"2d at C = 1 {hist} is not the all-gather's "
                                 f"{ag['llh_history']} bit for bit")
        body["bit_equal_allgather"] = cols == 1
        body["allgather_sec_per_iter"] = ag["sec_per_iter"]
        tag = f"csr_fused_2d_{TWOD_MESH // cols}x{cols}"
        out[tag] = body
        counts_by[tag] = body["launches"]
    return counts_by, out


def phase_twod_xlk(g, path, kb_hist) -> tuple:
    """`xl_k` through `cli fit --mesh 4,1 --partition 2d` at (4, 1) and
    (2, 2): csr_fused_2d_kb, twod_run's numbers against kb_main's one-card
    csr_fused_kb history."""
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan

    kc, k_pad = mesh_k_plan(XLK["k"], 1, True)
    out, counts_by = {"kc": kc, "k_pad": k_pad}, {}
    for cols in (1, 2):
        _, body = twod_run(g, path, XLK["k"], cols, "csr_fused_2d_kb", k_pad // kc,
                           kb_hist, "kb_main")
        tag = f"csr_fused_2d_kb_{TWOD_MESH // cols}x{cols}"
        out[tag] = body
        counts_by[tag] = body["launches"]
    return counts_by, out


def phase_twod_store(cache, F0) -> dict:
    """store_full's 4-shard cache through StoreTwoDShardedBigClamModel at
    (4, 1) and (2, 2) on the card: the baked closure lists (no streaming),
    the blobs read, and TWOD_STORE_ITERS steps from main's F0 (the cache's
    order is the text graph's, store_full checks) bit for bit the
    in-memory 2D trainer's on the cache's graph (history and F)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.parallel import (
        StoreTwoDShardedBigClamModel, TwoDShardedBigClamModel,
    )

    store = GraphStore.open(cache)
    g = store.load_graph()
    out = {}
    for cols in (1, 2):
        cfg = BigClamConfig(num_communities=FULL["k"], partition="2d",
                            replica_cols=cols, max_iters=TWOD_STORE_ITERS,
                            conv_tol=0.0)
        grid = twod_grid(STORE_SHARDS // cols, cols)
        t0 = time.perf_counter()
        st = StoreTwoDShardedBigClamModel(store, cfg, grid)
        build_st = time.perf_counter() - t0
        if "streamed" in st.path_reason or st.engaged_path != "csr_fused_2d":
            raise AssertionError(f"store 2d: {st.engaged_path}; {st.path_reason}")
        r_st = st.fit(F0)
        files = [f for group in st.files_read for f in group]
        del st
        t0 = time.perf_counter()
        mem = TwoDShardedBigClamModel(g, cfg, grid)
        build_mem = time.perf_counter() - t0
        r_mem = mem.fit(F0)
        del mem
        if (list(r_st.llh_history) != list(r_mem.llh_history)
                or not np.array_equal(r_st.F, r_mem.F)):
            raise AssertionError(f"store 2d at C = {cols} differs from the in-memory "
                                 "trainer")
        out[f"{STORE_SHARDS // cols}x{cols}"] = {
            "bit_equal_in_memory": True, "llh_history": list(r_st.llh_history),
            "files_read": len(files), "build_s_store": build_st,
            "build_s_in_memory": build_mem}
    return out


def phase_twod_parity(tmp) -> dict:
    """The parity graph: `csr_fused_2d` on (2, 2) of the card (5 steps from
    one conductance init) against the CPU float64 `xla_2d` on (2, 2) and on
    one device (LLH_RTOL); a (2, 2) fit checkpointed and resumed, bit for
    bit the uninterrupted fit; `sweep --mesh 4,1 --partition 2d
    --replica-cols 2` on the card against the CPU float64 one-device sweep:
    the same grid and chosen K (unless a stop ratio lies within 1e-4 of
    ksweep_tol)."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.parallel import TwoDShardedBigClamModel, make_mesh_2d
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    path = os.path.join(tmp, "twod_parity_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    cfg = BigClamConfig(num_communities=PARITY["k"], max_iters=4, conv_tol=0.0,
                        partition="2d", replica_cols=2)
    F0 = cli.init_F(g, cfg, "conductance")
    f64 = cfg.replace(dtype="float64")
    card = TwoDShardedBigClamModel(g, cfg, twod_grid(2, 2))
    cpu = TwoDShardedBigClamModel(g, f64, make_mesh_2d((2, 2), ["cpu"] * 4))
    if (card.engaged_path, cpu.engaged_path) != ("csr_fused_2d", "xla_2d"):
        raise AssertionError((card.engaged_path, cpu.engaged_path))
    reset_launch_counts()
    a = card.fit(F0).llh_history
    counts = {n: c for n, c in launch_counts().items() if c}
    b = cpu.fit(F0).llh_history
    one = BigClamModel(g, f64.replace(partition="1d", replica_cols=1),
                       device="cpu").fit(F0).llh_history
    rel = max(llh_rel(a, b), llh_rel(a, one))
    if rel > LLH_RTOL:
        raise AssertionError(f"2d card LLH {a} vs cpu float64 {b} / {one}")
    out = {"gpu_llh": a, "cpu_f64_2x2_llh": b, "cpu_f64_single_llh": one,
           "max_rel": rel, "launches": counts, "grad_exchange": card.grad_exchange}
    ck = cfg.replace(checkpoint_every=1)
    full = TwoDShardedBigClamModel(g, ck, twod_grid(2, 2)).fit(F0)
    cm = CheckpointManager(os.path.join(tmp, "twod_parity_ckpt"))
    TwoDShardedBigClamModel(g, ck.replace(max_iters=MESH_PARITY_CKPT_AT),
                            twod_grid(2, 2)).fit(F0, checkpoints=cm)
    res = TwoDShardedBigClamModel(g, ck, twod_grid(2, 2)).fit(F0, checkpoints=cm)
    if not np.array_equal(res.F, full.F) or (list(res.llh_history[-2:])
                                             != list(full.llh_history[-2:])):
        raise AssertionError("the resumed 2d fit differs from the uninterrupted one")
    out["resume_2x2"] = {"checkpoint_at": MESH_PARITY_CKPT_AT, "bit_equal": True}
    gpu, s_counts, _ = run_sweep(path, SWEEP_PARITY, [
        "--device", DEVICE, "--mesh", "4,1", "--partition", "2d",
        "--replica-cols", "2"])
    cpu_s, _, _ = run_sweep(path, SWEEP_PARITY, ["--device", "cpu", "--dtype", "float64"])
    llh = [cpu_s["llh_by_k"][str(k)] for k in cpu_s["kset"] if str(k) in cpu_s["llh_by_k"]]
    ratios = [1.0 - y / x for x, y in zip(llh, llh[1:])]
    near_tie = any(abs(r - 1e-3) <= 1e-4 for r in ratios)
    if gpu["kset"] != cpu_s["kset"] or (gpu["chosen_k"] != cpu_s["chosen_k"]
                                        and not near_tie):
        raise AssertionError(f"sweep --partition 2d chose {gpu['chosen_k']} on "
                             f"{gpu['kset']}, cpu float64 {cpu_s['chosen_k']}")
    common = [k for k in gpu["llh_by_k"] if k in cpu_s["llh_by_k"]]
    srel = max(abs(gpu["llh_by_k"][k] - cpu_s["llh_by_k"][k]) / abs(cpu_s["llh_by_k"][k])
               for k in common)
    if srel > LLH_RTOL:
        raise AssertionError(f"sweep 2d LLH {gpu['llh_by_k']} vs {cpu_s['llh_by_k']}")
    out["sweep_2d_2x2"] = {"kset": gpu["kset"],
                           "chosen_k": [gpu["chosen_k"], cpu_s["chosen_k"]],
                           "max_rel": srel, "stop_ratios": ratios,
                           "launches": {n: c for n, c in s_counts.items() if c}}
    return out


# --- quality on a K-sharded mesh, the serving fleet, the GEXF export ----------

# quality_tp's cut of the CLI schedule at full on (2, 2): 2 cycles of at
# most 20 steps and one repair round (the defaults are 40 cycles, 1,000
# steps a fit and 3 rounds; a tp_full step takes about 177 ms)
QUALITY_TP = dict(restart_cycles=2, max_iters=20, repair_rounds=1)
# F-sized tensors the device schedule keeps beside a fit's working set,
# which the memory model prices: the best state, and the kicked or edited
# input while its fit runs (quality_full's peak is main's plus 2 F)
QUALITY_RESIDENT_F = 2
QUALITY_TP_PARITY_ITERS = 30      # cycle 0's step cap on the parity graph
FLEET_SHARDS = 2
FLEET_UP_TIMEOUT_S = 300          # each replica imports torch and reaches the card
# the rounds before and after the restart route the mix's first ROUND1 and
# ROUND2 queries: round 1 was the whole 4,096 (16 s at 250 QPS) until a
# proof ran past the 1,200 s limit (PERF.md §6, PR 22)
FLEET_ROUND1_QUERIES = 1024
FLEET_ROUND2_QUERIES = 512


def shared_noise(seed: int):
    """The device schedule's kicks drawn once a tag on the CPU in float64
    (DeviceNoise's stream), handed to the card and to a CPU reference
    alike."""
    from bigclam_tpu_torch.models.quality import DeviceNoise

    draw = DeviceNoise(seed)

    def noise(tag, shape, eps, dtype, device):
        return draw(tag, shape, eps, torch.float64, "cpu").to(device, dtype)

    return noise


@contextlib.contextmanager
def quality_tp_schedule():
    """`cli fit --quality`'s config with QUALITY_TP's repair_rounds (the
    CLI has no flag for it)."""
    from bigclam_tpu_torch import cli

    orig = cli.quality_config

    def cut(args, cfg):
        return orig(args, cfg).replace(repair_rounds=QUALITY_TP["repair_rounds"])

    cli.quality_config = cut
    try:
        yield
    finally:
        cli.quality_config = orig


def phase_quality_tp(path, tmp, main_out, main_zero_rows, q_full, tp_body) -> dict:
    """`cli fit --mesh 2,2 --quality --device-annealing` at full on one
    card (QUALITY_TP's schedule): the launches of the K-sharded step (the
    window kernels and cand_nbr_from_x a block) against the steps run,
    steps and seconds a step beside quality_full's and tp_full's, stage
    seconds and transfer counts, the peak beside the fit's memory model
    plus QUALITY_RESIDENT_F F-sized tensors (check_peak), the zero rows
    and the LLH before and after. Then the parity graph at (2, 2) on the
    card against CPU float64 on a (2, 2) mesh fed the same kicks: cycle 0
    within LLH_RTOL, with its launches."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models import quality as q
    from bigclam_tpu_torch.models.agm import sample_planted_graph
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan
    from bigclam_tpu_torch.parallel import ShardedBigClamModel, make_mesh

    k = FULL["k"]
    fits = []                          # (steps, seconds) of each fit_state
    orig_fit_state = ShardedBigClamModel.fit_state

    def timed_fit_state(self, state, callback=None, **kw):
        t0 = time.perf_counter()
        res = orig_fit_state(self, state, callback=callback, **kw)
        fits.append((len(res[3]), time.perf_counter() - t0))
        return res

    metrics = os.path.join(tmp, "quality_tp.jsonl")
    args = fit_args([
        "--graph", path, "--k", str(k), "--init", "conductance", "--device",
        DEVICE, "--mesh", "2,2", "--quality", "--device-annealing",
        "--restart-cycles", str(QUALITY_TP["restart_cycles"]), "--max-iters",
        str(QUALITY_TP["max_iters"]), "--metrics", metrics])
    card = DEVICE == "cuda"
    ShardedBigClamModel.fit_state = timed_fit_state
    try:
        with quality_tp_schedule():
            if card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if card else 0
            reset_launch_counts()
            (out, res, qres), wall_s = wall(cli.fit, args)
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() - base if card else 0
    finally:
        ShardedBigClamModel.fit_state = orig_fit_state
    steps = cli_steps(metrics)
    n = out["n"]
    if res.F.shape != (n, k) or not np.isfinite(res.F).all():
        raise AssertionError("quality_tp: a malformed F")
    if card and (out["kernel_path"], out["mesh"]) != ("csr_fused", "2x2"):
        raise AssertionError(f"quality_tp ran {out['kernel_path']} on {out['mesh']}")
    if steps != sum(s for s, _ in fits) or not steps:
        raise AssertionError(f"quality_tp: {steps} steps recorded, fits {fits}")
    st = qres.stages
    rounds = st["counts"].get("repair_rounds", 0)
    if (st["counts"]["f_host_uploads"] != 1
            or st["counts"]["f_device_fetches"] > rounds + 1
            or rounds > QUALITY_TP["repair_rounds"]):
        raise AssertionError(f"quality_tp transfers: {st['counts']}")
    kc, k_pad = mesh_k_plan(k, 2, True)
    n_kb = (k_pad // 2) // (kc or k_pad // 2)
    want = tp_launches_want(counts, "allgather", 2, 2, n_kb, steps)
    if card and counts != want:
        raise AssertionError(f"quality_tp launches {counts}, want {want}")
    f_bytes = -(-n // 2) * 2 * k_pad * 4
    modeled = out["hbm_modeled_bytes"] + QUALITY_RESIDENT_F * f_bytes
    ratio = (check_peak("quality_tp 2x2", peak, modeled, 2) if card else None)
    # the parity graph at (2, 2): cycle 0 on the card against CPU float64
    p = PARITY
    g, _ = sample_planted_graph(p["n"], p["k"], p_in=p["p_in"],
                                rng=np.random.default_rng(p["seed"]))
    pcfg = BigClamConfig(num_communities=p["k"], quality_mode=True,
                         restart_cycles=1, quality_repair=False,
                         max_iters=QUALITY_TP_PARITY_ITERS)
    F0 = cli.init_F(g, pcfg, "conductance")
    noise = shared_noise(pcfg.seed)
    reset_launch_counts()
    pcard = q.fit_quality_device(ShardedBigClamModel(g, pcfg, grid_mesh(2, 2)),
                                 F0, noise=noise)
    pcounts = launch_counts()
    pcpu = q.fit_quality_device(
        ShardedBigClamModel(g, pcfg.replace(dtype="float64"),
                            make_mesh((2, 2), [torch.device("cpu")] * 4)),
        F0, noise=noise)
    a, b = pcard.fit.llh_history, pcpu.fit.llh_history
    prel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    c0 = abs(pcard.cycles_llh[0] - pcpu.cycles_llh[0]) / abs(pcpu.cycles_llh[0])
    if max(prel, c0) > LLH_RTOL or not all(map(math.isfinite, a)):
        raise AssertionError(f"quality_tp parity: card {a} vs cpu float64 {b}")
    pkc, pk_pad = mesh_k_plan(p["k"], 2, True)
    pwant = tp_launches_want(pcounts, "allgather", 2, 2,
                             (pk_pad // 2) // (pkc or pk_pad // 2), len(a))
    if card and pcounts != pwant:
        raise AssertionError(f"quality_tp parity launches {pcounts}, want {pwant}")
    anneal = fits[:qres.num_cycles]
    tp_sec = tp_body["csr_fused_2x2"]["sec_per_iter"]
    return {
        "schedule": QUALITY_TP, "schedule_seconds": wall_s,
        "stage_seconds": out["stage_seconds"], "stages": st,
        "cycles": qres.num_cycles, "cycles_llh": list(qres.cycles_llh),
        "total_iters": qres.total_iters, "repairs": qres.num_repairs,
        "steps": steps, "launches": counts, "k_pad": k_pad, "kc": kc,
        "fits": [{"steps": s, "seconds": t} for s, t in fits],
        "sec_per_step": sum(t for _, t in fits) / steps,
        "sec_per_step_anneal": (sum(t for _, t in anneal)
                                / max(sum(s for s, _ in anneal), 1)),
        "quality_full_sec_per_step": q_full["sec_per_step"],
        "tp_full_sec_per_step": tp_sec,
        "peak_gb_measured": peak / 1e9,
        "peak_gb_modeled_fit": out["hbm_modeled_bytes"] / 1e9,
        "peak_gb_modeled": modeled / 1e9, "peak_modeled_over_measured": ratio,
        "zero_rows_before": main_zero_rows,
        "zero_rows_after": int((~res.F.any(axis=1)).sum()),
        "llh_before": main_out["llh"], "llh_after": qres.fit.llh,
        "parity": {"n": g.num_nodes, "k": p["k"], "k_pad": pk_pad,
                   "steps_card": len(a), "steps_cpu": len(b), "max_rel": prel,
                   "cycle0_rel": c0, "cycle0_llh_card": pcard.cycles_llh[0],
                   "cycle0_llh_cpu": pcpu.cycles_llh[0], "launches": pcounts},
    }


def fleet_env() -> dict:
    """The environment of a child `python -m bigclam_tpu_torch.cli`: this
    checkout first on its path."""
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    return env


def read_members(path) -> dict:
    with open(path) as f:
        return {m["id"]: m for m in json.load(f)["members"]}


def route_round(fleet, members, qfile, results) -> tuple:
    """`cli route --members` of the query file: (its stats, its answers)."""
    out = cli_json(["route", "--fleet", fleet, "--members", members,
                    "--queries", qfile, "--results", results, "--quiet"])
    if out["serve_errors"] or out["mixed_generation"]:
        raise AssertionError(f"route: {out}")
    with open(results) as f:
        return out, [json.loads(line) for line in f]


def hold_routed(queries, answers, single, snap, gi, held=None) -> dict:
    """Routed reads equal the single-process answers bit for bit; routed
    suggests (the first `held` of them, all by default) against the CPU
    float64 engine (hold_suggests)."""
    sq, sa = [], []
    for q, a, b in zip(queries, answers, single):
        if "error" in a:
            raise AssertionError(f"routed {q}: {a}")
        if q["family"] == "suggest_for":
            sq.append(q)
            sa.append(a)
        elif q["family"] == "members_of":
            if a["members"] != b["members"]:
                raise AssertionError(f"routed {q}: members differ")
        elif a["communities"] != b["communities"]:
            raise AssertionError(f"routed {q}: communities differ")
    return {"reads_equal": len(queries) - len(sq), "suggests": len(sq),
            "held_vs_cpu_float64": hold_suggests(snap, gi, sq[:held], sa[:held])}


def phase_fleet_full(gi, tmp, cache, serve_body) -> dict:
    """A 2-shard fleet generation of serve_publish's sparse fit (`cli fit
    --representation sparse --sparse-m 64 --publish-shards 2` on
    store_full's cache) started by `cli fleet up --shards 2 --replicas 1
    --device cuda` with a members file; the first FLEET_ROUND1_QUERIES of
    serve_full's mix routed by `cli route --members`: reads equal
    single-process `cli serve` on the un-sharded archive of the same
    member lists bit for bit, suggests within 1e-4 of CPU float64, no
    serve error, every replica on the card; then one replica killed,
    restarted by the supervisor, and a second round of the mix's first
    FLEET_ROUND2_QUERIES answering the same (its first SERVE_CHECK
    suggests held); `fleet drain` and `fleet down`. The dense fit's fleet would answer each members_of with
    its 110,400 zero rows (serve_full), 4,096 times a round, as JSON."""
    import signal

    from bigclam_tpu_torch.ops.sparse_members import from_dense
    from bigclam_tpu_torch.serve.router import TcpReplica
    from bigclam_tpu_torch.serve.snapshot import (
        ServingSnapshot,
        load_fleet_shard,
        publish_snapshot,
    )

    card = DEVICE == "cuda"
    n, k = gi.num_nodes, FULL["k"]
    fleet = os.path.join(tmp, "fleet")
    f_npy = os.path.join(tmp, "fleet_F.npy")
    out, res, state, counts, pub_s = serve_fit([
        "--graph", cache, "--max-iters", str(SERVE_SPARSE_ITERS),
        "--representation", "sparse", "--sparse-m", str(SPARSE_M),
        "--publish-dir", fleet, "--publish-shards", str(FLEET_SHARDS),
        "--save-f", f_npy])
    del state
    if out["publish_shards"] != FLEET_SHARDS:
        raise AssertionError(f"fleet publication: {out}")
    if card and (out["kernel_path"] != "sparse_merge_pallas"
                 or not counts["member_lookup"]):
        raise AssertionError(f"fleet fit {out['kernel_path']} {counts}")
    F = np.load(f_npy)
    if not np.array_equal(F, res.F):
        raise AssertionError("the fleet fit's --save-f F is not its F")
    del res
    os.remove(f_npy)
    # the un-sharded archive of the same member lists, as the fit cut them
    ids, w, _ = from_dense(F, SPARSE_M, k, n)
    del F
    single_dir = os.path.join(tmp, "fleet_single")
    publish_snapshot(single_dir, step=None, ids=ids, w=w, raw_ids=gi.raw_ids,
                     num_edges=gi.num_edges,
                     cfg=snapshot_cfg(load_fleet_shard(fleet, 0).meta),
                     meta={"llh": out["llh"]})
    del ids, w
    with open(os.path.join(tmp, "serve_queries.jsonl")) as f:
        queries = [json.loads(line) for line in f][:FLEET_ROUND1_QUERIES]
    qfile = os.path.join(tmp, "fleet_round1.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    single_out = cli_json(["serve", "--snapshots", single_dir, "--graph", cache,
                           "--queries", qfile, "--results",
                           os.path.join(tmp, "fleet_single.jsonl"), "--device",
                           DEVICE, "--quiet"])
    with open(os.path.join(tmp, "fleet_single.jsonl")) as f:
        single = [json.loads(line) for line in f]
    snap = ServingSnapshot.load(single_dir)
    members = os.path.join(tmp, "fleet_members.json")
    logs = os.path.join(tmp, "fleet_logs")
    t0 = time.perf_counter()
    up = subprocess.Popen(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", "fleet", "up", "--fleet",
         fleet, "--shards", str(FLEET_SHARDS), "--replicas", "1", "--graph", cache,
         "--members", members, "--device", DEVICE, "--log-dir", logs,
         "--up-timeout-s", str(FLEET_UP_TIMEOUT_S), "--drain-grace-s", "0.2"],
        stdout=subprocess.PIPE, text=True, env=fleet_env(),
        start_new_session=True)
    try:
        hello = json.loads(up.stdout.readline() or "{}")
        up_s = time.perf_counter() - t0
        if not hello.get("all_up"):
            raise AssertionError(f"fleet up: {hello}")
        ctl = ["--control", hello["control"]]
        devices = {}
        for mid, m in read_members(members).items():
            host, port = m["endpoint"].rsplit(":", 1)
            t = TcpReplica(host, int(port), timeout_s=60.0)
            try:
                devices[mid] = t.request({"family": "status"})["device"]
            finally:
                t.close()
        if card and set(devices.values()) != {"cuda"}:
            raise AssertionError(f"fleet replicas on {devices}")
        stats1, answers1 = route_round(fleet, members, qfile,
                                       os.path.join(tmp, "routed1.jsonl"))
        held1 = hold_routed(queries, answers1, single, snap, gi)
        # kill one replica: the supervisor restarts it at the newest generation
        victim = read_members(members)["s0r0"]
        os.kill(victim["pid"], signal.SIGKILL)
        t_kill = time.perf_counter()
        while True:
            m = read_members(members)["s0r0"]
            if m["pid"] != victim["pid"] and m["state"] == "up":
                break
            if time.perf_counter() - t_kill > FLEET_UP_TIMEOUT_S:
                raise AssertionError(f"s0r0 not restarted: {m}")
            time.sleep(0.05)
        restart_s = time.perf_counter() - t_kill
        q2 = os.path.join(tmp, "fleet_round2.jsonl")
        with open(q2, "w") as f:
            f.writelines(json.dumps(q) + "\n" for q in queries[:FLEET_ROUND2_QUERIES])
        stats2, answers2 = route_round(fleet, members, q2,
                                       os.path.join(tmp, "routed2.jsonl"))
        held2 = hold_routed(queries[:FLEET_ROUND2_QUERIES], answers2, single,
                            snap, gi, SERVE_CHECK)
        drain = cli_json(["fleet", "drain", "--member", "s1r0", *ctl])
        if not drain.get("ok"):
            raise AssertionError(f"fleet drain: {drain}")
        cli_json(["fleet", "down", *ctl])
        final = json.loads(up.stdout.read().strip().splitlines()[-1])
        if up.wait(timeout=120) != 0 or final["replica_restarts"] < 1:
            raise AssertionError(f"fleet up ended {up.returncode}: {final}")
    finally:
        if up.poll() is None:
            os.killpg(up.pid, signal.SIGKILL)
            up.wait()
    keys = ("serve_p50_s", "serve_p99_s", "serve_qps", "serve_queries",
            "serve_errors", "router_retries", "transport_failovers")
    return {
        "publication": {"generation": out["generation"], "publish_s": pub_s,
                        "shards": FLEET_SHARDS, "kernel_path": out["kernel_path"],
                        "launches": counts, "steps": out["steps"]},
        "fleet_up_s": up_s, "replica_devices": devices,
        "round1": {key: stats1.get(key) for key in keys}, "held1": held1,
        "restart_s": restart_s,
        "round2": {key: stats2.get(key) for key in keys}, "held2": held2,
        "single_process": {key: single_out.get(key) for key in keys},
        "serve_full": {tag: {key: serve_body[tag][key] for key in (
            "serve_p50_s", "serve_p99_s", "serve_qps")} for tag in ("dense", "sparse")},
        "final": final,
    }


def gexf_nodes(path) -> tuple:
    """{node id: (community, n_communities)} and the edge count of a GEXF
    file."""
    import xml.etree.ElementTree as ET

    ns = {"g": "http://gexf.net/1.2"}
    root = ET.parse(path).getroot()
    nodes = {}
    for node in root.iterfind(".//g:nodes/g:node", ns):
        vals = {v.get("for"): int(v.get("value"))
                for v in node.iterfind(".//g:attvalue", ns)}
        nodes[node.get("id")] = (vals["0"], vals["1"])
    return nodes, len(root.findall(".//g:edges/g:edge", ns))


def phase_gexf(tmp) -> dict:
    """`cli fit --export-gexf` on the parity graph on the card (csr_fused, a
    launch a step) and in CPU float64: the file parses, its nodes and
    edges are the graph's, and its community attributes equal the CPU
    run's but at near-ties (TIE) in either run's F: the primary community
    only where the row's top two are near-tied, the membership count only
    where a column lies near the delta threshold (or the row's maximum,
    below it, is near-tied with its second)."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.ops.extraction import delta_threshold

    path = os.path.join(tmp, "gexf_graph.txt")
    planted_file(PARITY, path)
    g = build_graph(path)
    base = ["--graph", path, "--k", str(PARITY["k"]), "--max-iters", "4",
            "--conv-tol", "0", "--init", "conductance"]
    runs = {}
    for tag, extra in (("card", ["--device", DEVICE]),
                       ("cpu", ["--device", "cpu", "--dtype", "float64"])):
        gexf = os.path.join(tmp, f"gexf_{tag}.gexf")
        reset_launch_counts()
        out, res, _ = cli.fit(fit_args(base + extra + ["--export-gexf", gexf]))
        counts = launch_counts()
        if out["export_gexf"] != gexf:
            raise AssertionError(f"gexf {tag}: {out.get('export_gexf')}")
        nodes, edges = gexf_nodes(gexf)
        if (len(nodes), edges) != (g.num_nodes, g.num_edges):
            raise AssertionError(f"gexf {tag}: {len(nodes)} nodes, {edges} edges; "
                                 f"the graph has {g.num_nodes}, {g.num_edges}")
        runs[tag] = {"out": out, "F": res.F, "nodes": nodes, "counts": counts,
                     "bytes": os.path.getsize(gexf)}
    card = runs["card"]
    if DEVICE == "cuda" and (card["out"]["kernel_path"] != "csr_fused"
                             or card["counts"]["fused_superstep"] != card["out"]["steps"]):
        raise AssertionError(f"gexf fit {card['out']['kernel_path']} {card['counts']}")
    delta = delta_threshold(g.num_nodes, g.num_edges)
    flips = 0
    for u in range(g.num_nodes):          # a GEXF node id is its row
        att, want = card["nodes"][str(u)], runs["cpu"]["nodes"][str(u)]
        if att == want:
            continue
        rows = (card["F"][u], runs["cpu"]["F"][u])
        tops = [np.sort(row)[-2:] for row in rows]
        # the primary community (argmax) at a near-tie of the row's top two
        near_top = any(t[1] - t[0] <= TIE * max(1.0, t[1]) for t in tops)
        # the membership count at a column near delta, or at the fallback
        # to the row's maximum (below delta) at a near-tie of its top two
        near_count = any(np.any(np.abs(row - delta) <= TIE * max(1.0, delta))
                         for row in rows) or (
            near_top and min(t[1] for t in tops) < delta * (1 + TIE))
        if ((att[0] != want[0] and not near_top)
                or (att[1] != want[1] and not near_count)):
            raise AssertionError(f"gexf row {u}: card {att}, cpu {want}")
        flips += 1
    return {"n": g.num_nodes, "edges": g.num_edges,
            "launches": card["counts"]["fused_superstep"],
            "steps": card["out"]["steps"], "bytes": card["bytes"],
            "near_tie_flips": flips,
            "llh_card": card["out"]["llh"], "llh_cpu": runs["cpu"]["out"]["llh"],
            "stage_seconds": card["out"]["stage_seconds"]}


# the multi-process phase: each run's rank 0 runs in this process through
# cli.fit, ranks 1.. as `python -c DIST_RANK_CODE <fit argv>` from a
# directory of their own; a rank that fails, or a run past DIST_TIMEOUT_S,
# ends the script (a rank blocked in a collective cannot be interrupted)
DIST_TIMEOUT_S = 150
DIST_RANK_CODE = """
import json, os, sys, time
import torch.distributed as dist
from bigclam_tpu_torch import cli
from bigclam_tpu_torch.parallel import multihost as mh
while not os.path.exists(os.environ["CHIP_SMOKE_DIST_GO"]):
    time.sleep(0.02)
built = []
make = cli.make_mesh_model
def spy(*a, **kw):
    built.append(make(*a, **kw))
    built.append(dist.get_backend())
    return built[0]
cli.make_mesh_model = spy
rc = cli.main(["fit", *sys.argv[1:]])
hs = getattr(built[0], "host_shard", None) if built else None
print(json.dumps({"rc": rc, "origin": list(built[0].mesh.origin) if built else None,
                  "backend": built[1] if built else None,
                  "files_read": list(hs.files_read) if hs is not None else None,
                  "cross_rank_bytes": mh.cross_rank_bytes()}), file=sys.stderr)
sys.exit(rc)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_env(world: int, rank: int, port: int, backend) -> dict:
    """torchrun's variables for one rank on this host (and the backend
    override, where given)."""
    from bigclam_tpu_torch.parallel.multihost import BACKEND_ENV

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": str(rank)}
    if backend:
        env[BACKEND_ENV] = backend
    return env


# every rank subprocess the phase started: all are killed when a run fails
DIST_PROCS = []


def kill_dist_procs() -> None:
    for p in DIST_PROCS:
        if p.poll() is None:
            p.kill()
            p.wait()


def dist_spawn(tag: str, argv, world: int, backend, tmp, ports: set) -> dict:
    """Ranks 1.. of `cli fit <argv> --distributed` on `world` ranks of this
    host, started as subprocesses ahead of rank 0 (started during the run
    before, their imports overlap it; each then waits for the run's go
    file, which dist_run writes as rank 0 starts: a rank that waits in the
    rendezvous instead retries its connection at growing intervals, 10 s
    late), each from its own empty directory <tmp>/<tag>_rank<r> (so what
    each wrote is what that directory holds), on a port no other run of
    the phase takes; dist_run runs rank 0."""
    from bigclam_tpu_torch.parallel.multihost import BACKEND_ENV

    argv = [*argv, "--distributed"]
    port = free_port()
    while port in ports:
        port = free_port()
    ports.add(port)
    dirs = [os.path.join(tmp, f"{tag}_rank{r}") for r in range(world)]
    for d in dirs:
        os.makedirs(d)
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    for r in range(1, world):
        env = {k: v for k, v in os.environ.items() if k != BACKEND_ENV}
        env.update(dist_env(world, r, port, backend),
                   PYTHONPATH=here + os.pathsep + env.get("PYTHONPATH", ""),
                   CHIP_SMOKE_DIST_GO=os.path.join(tmp, f"{tag}.go"))
        so = open(os.path.join(tmp, f"{tag}_rank{r}.out"), "w")
        se = open(os.path.join(tmp, f"{tag}_rank{r}.err"), "w")
        logs.append((so, se))
        procs.append(subprocess.Popen([sys.executable, "-c", DIST_RANK_CODE, *argv],
                                      cwd=dirs[r], env=env, stdout=so, stderr=se))
        DIST_PROCS.append(procs[-1])
    return {"tag": tag, "argv": argv, "world": world, "backend": backend,
            "port": port, "dirs": dirs, "procs": procs, "logs": logs,
            "go": os.path.join(tmp, f"{tag}.go")}


def dist_run(spawned: dict) -> dict:
    """Rank 0 of a dist_spawn'ed run in this process, with the launch
    counters zeroed just before and read just after, its model and the
    process group's backend captured at the build; then the other ranks'
    ends. Returns rank 0's (out, res), launch counts, model, graph,
    backend, cross-rank bytes and seconds (from rank 0's start), and each
    other rank's JSON, its report line (origin, backend, files_read,
    cross-rank bytes) and directory."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.parallel import multihost as mh
    from bigclam_tpu_torch.parallel.multihost import BACKEND_ENV

    tag, argv, world, backend = (spawned[k] for k in ("tag", "argv", "world",
                                                       "backend"))
    port, dirs, procs, logs = (spawned[k] for k in ("port", "dirs", "procs", "logs"))
    t0 = time.perf_counter()
    done = threading.Event()

    def watchdog():
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while not done.wait(0.5):
            bad = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                kill_dist_procs()
                emit({"phase": "dist", "error": f"{tag}: a rank exited {bad}"
                      if bad else f"{tag}: past {DIST_TIMEOUT_S} s"})
                os._exit(1)

    threading.Thread(target=watchdog, daemon=True).start()
    built = []
    make = cli.make_mesh_model

    def spy(*a, **kw):
        import torch.distributed as dist

        built.append((make(*a, **kw), a[0], dist.get_backend()))
        return built[-1][0]

    saved = {k: os.environ.get(k) for k in (*dist_env(world, 0, port, "gloo"),)}
    cwd = os.getcwd()
    try:
        os.environ.update(dist_env(world, 0, port, backend))
        if not backend:
            os.environ.pop(BACKEND_ENV, None)
        os.chdir(dirs[0])
        cli.make_mesh_model = spy
        args = cli.build_parser().parse_args(["fit", *argv])
        reset_launch_counts()
        mh.reset_cross_rank_bytes()
        open(spawned["go"], "w").close()
        try:
            out, res, _ = cli.fit(args)
        finally:
            mh.shutdown_distributed()
        counts = launch_counts()
        seconds0 = time.perf_counter() - t0
        others = []
        for p, (so, se), r in zip(procs, logs, range(1, world)):
            rc = p.wait(timeout=max(DIST_TIMEOUT_S - (time.perf_counter() - t0), 1))
            so.close()
            se.close()
            if rc != 0:
                raise AssertionError(f"{tag}: rank {r} exited {rc}")
            with open(so.name) as f:
                fit_json = json.loads(f.read().strip().splitlines()[-1])
            with open(se.name) as f:
                report = json.loads(f.read().strip().splitlines()[-1])
            others.append({"out": fit_json, "report": report, "dir": dirs[r]})
    except BaseException:
        kill_dist_procs()
        raise
    finally:
        done.set()
        cli.make_mesh_model = make
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    model, g, used = built[0]
    return {"out": out, "res": res, "counts": counts, "model": model, "graph": g,
            "backend": used, "cross": mh.cross_rank_bytes(), "dir": dirs[0],
            "seconds": time.perf_counter() - t0, "seconds_rank0": seconds0,
            "others": others}


def same_history(tag: str, got, want, deterministic: bool, why: str) -> float:
    """A distributed run's LLH history against the same steps of its
    single-controller run (which may run more): bit for bit, or within
    DIST_RTOL where the single-controller runs themselves differ run to
    run (`why` names that non-determinism)."""
    want = want[:len(got)]
    if len(got) < 2 or len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} LLH values against {len(want)}")
    if got == want:
        return 0.0
    rel = llh_rel(got, want)
    if deterministic or rel > DIST_RTOL:
        raise AssertionError(f"{tag}: LLH {got} vs the single controller's {want}"
                             + ("" if deterministic else f" ({why}: {rel})"))
    return rel


DIST_RTOL = 1e-5
DIST_SHARDS = {0: (0, 1), 1: (2, 3)}      # gloo2_full: each rank's shard files
# the two gloo runs' steps (0..2), held against the first steps of their
# single-controller runs: a gloo step took 4.21 s at full and 1.23 s at
# xl_k, and a proof with 4 and 5 ran past the 1,200 s limit (PR 22)
DIST_GLOO_ITERS = 2


def dist_body(run: dict) -> dict:
    """The numbers a dist run prints: per rank sec_per_iter, stage seconds
    and the bytes it moved across ranks."""
    out = run["out"]
    return {
        "kernel_path": out["kernel_path"], "mesh": out["mesh"],
        "backend": run["backend"], "llh_history": out["llh_history"],
        "steps": out["steps"], "launches_rank0": run["counts"],
        "seconds": run["seconds"],
        "ranks": [{"sec_per_iter": out["sec_per_iter"],
                   "stage_seconds": out["stage_seconds"],
                   "cross_rank_bytes": run["cross"]}]
        + [{"sec_per_iter": o["out"]["sec_per_iter"],
            "stage_seconds": o["out"]["stage_seconds"],
            "cross_rank_bytes": o["report"]["cross_rank_bytes"]}
           for o in run["others"]],
    }


def phase_dist(cache, xlk_path, tmp, dp4: dict, kbmesh: dict) -> tuple:
    """Multi-process meshes (parallel/multihost.py) on the one card:
    nccl1, one NCCL rank, `cli fit --distributed --mesh 4,1 --store-native
    --schedule ring` on store_full's cache, its history store_native_dp4's
    ring run's; gloo2_full, two ranks over gloo sharing the card, the same
    cache on the all-gather schedule with --out, checkpoints and telemetry:
    store_native_dp4's all-gather history, each rank reading its two
    shards, rank 0 alone writing (the communities file held by hold_writer
    against the fetched F, every byte), `processes: 2` in the events;
    gloo2_xlk, two ranks at --mesh 2,2 on the xl_k file in memory, a node
    row of column blocks each: kbmesh_xlk's (2, 2) all-gather history.
    The gloo runs take DIST_GLOO_ITERS steps, held against the same first
    steps of their single controllers, and each one's rank 1 starts
    during the run before. Each run's launches on rank 0 are its
    positions' share of the schedule's."""
    try:
        return dist_phase_runs(cache, xlk_path, tmp, dp4, kbmesh)
    finally:
        kill_dist_procs()


def dist_phase_runs(cache, xlk_path, tmp, dp4: dict, kbmesh: dict) -> tuple:
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan

    body, counts, ports = {}, {}, set()
    base = ["--init", "conductance", "--conv-tol", "0", "--device", DEVICE, "--quiet"]
    store = ["--graph", cache, "--k", str(FULL["k"]), "--mesh", f"{STORE_SHARDS},1",
             "--store-native", *base]

    gloo = ["--max-iters", str(DIST_GLOO_ITERS)]
    full = dist_spawn("gloo2_full", [*store, *gloo, "--out", "communities.txt",
                                     "--checkpoint-dir", "ck", "--checkpoint-every",
                                     "2", "--telemetry-dir", "tel"], 2, "gloo", tmp,
                      ports)
    run = dist_run(dist_spawn("nccl1", [*store, "--max-iters", str(STORE_ITERS),
                                        "--schedule", "ring"], 1, None, tmp, ports))
    out, ring = run["out"], dp4["ring"]
    if (run["backend"], out["kernel_path"], out["mesh"]) != ("nccl", "csr_ring_fused",
                                                             "4x1"):
        raise AssertionError(f"nccl1 ran {out['kernel_path']} on {out['mesh']} over "
                             f"{run['backend']}")
    want = ring_launches_want(run["counts"], STORE_SHARDS, out["steps"])
    if run["counts"] != want:
        raise AssertionError(f"nccl1 launches {run['counts']}, want {want}")
    rel = same_history("nccl1", out["llh_history"], ring["llh_history"],
                       ring["in_memory_runs_bit_identical"] is not False,
                       "the ring's run-to-run band (store_native_dp4)")
    body["nccl1"] = {**dist_body(run), "max_rel_vs_single_controller": rel}
    counts["nccl1"] = run["counts"]
    del run

    xlk = dist_spawn("gloo2_xlk", ["--graph", xlk_path, "--k", str(XLK["k"]),
                                   "--mesh", "2,2", *base, *gloo], 2, "gloo", tmp,
                     ports)
    run = dist_run(full)
    out, ag = run["out"], dp4["allgather"]
    if (run["backend"], out["kernel_path"]) != ("gloo", "csr_fused"):
        raise AssertionError(f"gloo2_full ran {out['kernel_path']} over {run['backend']}")
    rank1 = run["others"][0]
    if rank1["out"]["llh_history"] != out["llh_history"]:
        raise AssertionError("gloo2_full: the ranks' histories differ")
    rel = same_history("gloo2_full", out["llh_history"], ag["llh_history"],
                       ag["in_memory_runs_bit_identical"] is not False,
                       "the all-gather's run-to-run band (store_native_dp4)")
    want = {**dict.fromkeys(run["counts"], 0),
            "fused_superstep": 2 * out["steps"]}
    if run["counts"] != want:
        raise AssertionError(f"gloo2_full launches {run['counts']}, want {want}")
    files = {0: set(run["model"].host_shard.files_read),
             1: set(rank1["report"]["files_read"])}
    for r, ids in DIST_SHARDS.items():
        own = {f"shard_{s:05d}.{kind}.npy" for s in ids for kind in ("indptr", "indices")}
        if files[r] != own:
            raise AssertionError(f"gloo2_full: rank {r} read {sorted(files[r])}")
    d0, d1 = run["dir"], rank1["dir"]
    ck0 = sorted(f for f in os.listdir(os.path.join(d0, "ck")) if f.endswith(".npz"))
    wrote1 = sorted(os.path.relpath(os.path.join(r, f), d1)
                    for r, _, fs in os.walk(d1) for f in fs)
    if not ck0 or not os.path.exists(os.path.join(d0, "tel", "events.jsonl")):
        raise AssertionError(f"gloo2_full: rank 0 wrote checkpoints {ck0} and "
                             f"{os.listdir(os.path.join(d0, 'tel'))}")
    # rank 1 keeps its own run report (and the run id it resolved) only
    if set(wrote1) - {os.path.join("tel", "run_report.p1.json"),
                      os.path.join("tel", "run_id")}:
        raise AssertionError(f"gloo2_full: rank 1 wrote {wrote1}")
    with open(os.path.join(d0, "tel", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    init = [e for e in events if e["kind"] == "distributed_init"]
    with open(os.path.join(d0, "tel", "run_report.json")) as f:
        report = json.load(f)
    if (not init or init[0]["processes"] != 2 or report["processes"] != 2
            or any(e["pid"] != 0 for e in events)):
        raise AssertionError(f"gloo2_full: events {init}, report processes "
                             f"{report['processes']}")
    held = hold_writer(os.path.join(d0, "communities.txt"), run["res"].F, run["graph"])
    body["gloo2_full"] = {
        **dist_body(run), "max_rel_vs_single_controller": rel,
        "files_read": {r: sorted(v) for r, v in files.items()},
        "rank0_checkpoints": ck0, "rank1_wrote": wrote1,
        "events": len(events), "processes": report["processes"],
        "communities": {**held, "communities": out["communities"]},
    }
    counts["gloo2_full"] = run["counts"]
    del run

    run = dist_run(xlk)
    out, ref = run["out"], kbmesh["csr_fused_kb_2x2"]
    if (out["kernel_path"], out["mesh"]) != ("csr_fused_kb", "2x2"):
        raise AssertionError(f"gloo2_xlk ran {out['kernel_path']} on {out['mesh']}")
    if run["others"][0]["report"]["origin"] != [1, 0]:
        raise AssertionError(f"gloo2_xlk: rank 1 at {run['others'][0]['report']}")
    if run["others"][0]["out"]["llh_history"] != out["llh_history"]:
        raise AssertionError("gloo2_xlk: the ranks' histories differ")
    rel = same_history("gloo2_xlk", out["llh_history"], ref["llh_history"], True, "")
    kc, k_pad = mesh_k_plan(XLK["k"], 2, True)
    want = tp_launches_want(run["counts"], "allgather", 1, 2,
                            (k_pad // 2) // (kc or k_pad // 2), out["steps"])
    if run["counts"] != want:
        raise AssertionError(f"gloo2_xlk launches {run['counts']}, want {want}")
    body["gloo2_xlk"] = {**dist_body(run), "max_rel_vs_single_controller": rel}
    counts["gloo2_xlk"] = run["counts"]
    return counts, body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--against", action="append", default=[], metavar="DIR=KERNELS",
        help="another tree's kernel sources (a csrc directory with this "
        "tree's C signatures) and the KERNELS names, comma-separated, to set "
        "beside this tree's build: SASS, outputs bit for bit, times",
    )
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    # fails outside a checkout
    from bigclam_tpu_torch.graph.ingest import build_graph

    t_all = time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        body = res[-1] if isinstance(res, tuple) else res
        emit({"phase": name, "seconds": time.perf_counter() - t0, **body})
        return res

    run("card", phase_card)
    run("build", phase_build)
    run("against", phase_against, args.against)
    run("odd", phase_odd)
    ring_odd_checks, _ = run("ring_odd", phase_ring_odd)
    run("sparse_odd", phase_sparse_odd)
    sm_odd_check, _ = run("sparse_mesh_odd", phase_sparse_mesh_odd)
    run("vmem_odd", phase_vmem_odd)
    run("host_odd", phase_host_odd)
    run("quality_odd", phase_quality_odd)
    kbmesh_odd_checks, _ = run("kbmesh_odd", phase_kbmesh_odd)
    twod_odd_checks, _ = run("twod_odd", phase_twod_odd)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "full_graph.txt")
        g = planted_file(FULL, path)
        emit({"phase": "graph", "seconds": time.perf_counter() - t0,
              "n": g.num_nodes, "directed_edges": g.num_directed_edges})
        main_out, res, main_counts, state, _ = run("main", phase_main, g, path, tmp)
        run("host_full", phase_host_full, g, path, state, res.F)
        del state
        main_hist = list(res.llh_history)
        main_zero_rows = int((~res.F.any(axis=1)).sum())
        t0 = time.perf_counter()
        gi, F0 = mesh_init(path)
        emit({"phase": "mesh_init", "seconds": time.perf_counter() - t0,
              "n": gi.num_nodes, "directed_edges": gi.num_directed_edges})
        # later full-size cli runs read this cache in place of the text
        cache, _ = run("store_full", phase_store_full, gi, path, tmp, F0,
                       main_out, main_counts)
        split_counts, _ = run("split", phase_split, g, cache, tmp, main_hist)
        checks, times, bnd, _ = run("full", phase_full, g, res.F, F0)
        del res
        res_full = run("resilience_full", phase_resilience_full, g, cache, tmp, gi,
                       F0, main_out)
        run("obs_memory", phase_obs_memory, gi, F0, "full")
        run("obs_profile", phase_obs_profile, gi, cache, "full", F0)
        state, sparse_counts, sp_main = run("sparse_main", phase_sparse_main, g, cache)
        sp_checks, sp_times, sp_bnd, _ = run("sparse_full", phase_sparse_full, g, state)
        cand_check, cand_times, cand_bnd, _ = run("cand_sweep_yt", phase_cand_sweep_yt)
        del state
        sm_full_counts, _ = run("sparse_mesh_full", phase_sparse_mesh_full, g, gi,
                                cache, F0, sp_main)
        sm_local_counts, _ = run("sparse_mesh_local", phase_sparse_mesh_local)
        res, vmem_counts, _ = run("vmem_main", phase_vmem_main, g, cache, main_hist)
        vm_checks, vm_times, vm_bnd, _ = run("vmem_full", phase_vmem_full, g, res.F)
        del res
        run("sweep_main", phase_sweep_main, g, cache)
        ring_main_counts, _ = run("ring_main", phase_ring_main, g, cache, main_hist)
        model, state, ring_counts, ring_dp4_body = run("ring_dp4", phase_ring_dp4,
                                                       gi, F0, main_hist)
        ring_checks, ring_times, ring_bnd, _ = run("ring_full", phase_ring_full,
                                                   model, state)
        del model, state
        ag_body = run("allgather_main", phase_allgather_main, g, cache, gi, F0,
                      main_hist)
        run("ring_multi", phase_ring_multi, gi, F0, main_hist)
        tp_full_counts, tp_full_body = run("tp_full", phase_tp_full, gi, F0,
                                           main_hist, main_out["sec_per_iter"])
        twod_full_counts, _ = run("twod_full", phase_twod_full, g, cache, main_hist)
        _, dp4_body = run("store_native_dp4", phase_store_native_dp4, gi, path, tmp,
                          cache, F0, ag_body["csr_fused"]["sec_per_iter"],
                          ring_dp4_body["csr_ring_fused"]["sec_per_iter"])
        run("twod_store", phase_twod_store, cache, F0)
        run("store_heal", phase_store_heal, path, tmp, cache, main_out)
        run("store_delta", phase_store_delta, gi, path, tmp, cache)
        q_full = run("quality_full", phase_quality_full, gi, F0, main_out,
                     main_zero_rows)
        del g, F0
        q_tp = run("quality_tp", phase_quality_tp, cache, tmp, main_out,
                   main_zero_rows, q_full, tp_full_body)
        snaps, snaps_sparse, _ = run("serve_publish", phase_serve_publish,
                                     gi, tmp, cache)
        serve_body = run("serve_full", phase_serve_full, gi, tmp, cache, snaps,
                         snaps_sparse)
        run("refit_full", phase_refit_full, gi, tmp, cache, snaps)
        fleet_body = run("fleet_full", phase_fleet_full, gi, tmp, cache, serve_body)
        del gi
        run("follow_parity", phase_follow_parity, tmp)
        q_parity = run("quality_parity", phase_quality_parity, tmp)
        gexf_body = run("gexf", phase_gexf, tmp)
        run("parity", phase_parity, tmp)
        run("sparse_parity", phase_sparse_parity, tmp)
        run("sparse_mesh_parity", phase_sparse_mesh_parity, tmp)
        run("vmem_parity", phase_vmem_parity, tmp)
        run("sweep_parity", phase_sweep_parity, tmp)
        run("mesh_parity", phase_mesh_parity, tmp)
        run("twod_parity", phase_twod_parity, tmp)
        run("resilience_odd", phase_resilience_odd, tmp)
        run("obs_ledger", phase_obs_ledger, tmp)

        t0 = time.perf_counter()
        path = os.path.join(tmp, "xl_k_graph.txt")
        sampled = planted_file(XLK, path)
        # the graph as `cli fit --graph` reads it: an edge list has no
        # isolated nodes, so the sampled graph's drop out
        g = build_graph(path)
        emit({"phase": "kb_graph", "seconds": time.perf_counter() - t0,
              "n_sampled": sampled.num_nodes, "n": g.num_nodes,
              "directed_edges": g.num_directed_edges})
        del sampled
        run("host_xlk", phase_host_xlk, g)
        res, kb_counts, _ = run("kb_main", phase_kb_main, g, path)
        kb_split_counts, _ = run("kb_split", phase_kb_split, g, path,
                                 list(res.llh_history))
        kb_checks, kb_times, kb_bnd, _ = run("kb_full", phase_kb_full, g, res.F)
        kb_res_counts, _ = run("resilience_kb", phase_resilience_kb, g, res.F)
        F_kb = np.asarray(res.F, np.float64)
        kbmesh_counts, kbmesh_body = run("kbmesh_xlk", phase_kbmesh_xlk, g, path,
                                         list(res.llh_history), F_kb)
        dist_counts, _ = run("dist", phase_dist, cache, path, tmp, dp4_body,
                             kbmesh_body)
        twod_xlk_counts, _ = run("twod_xlk", phase_twod_xlk, g, path,
                                 list(res.llh_history))
        run("store_kb", phase_store_kb, path, tmp)
        run("obs_memory", phase_obs_memory, g, F_kb, "xl_k")
        run("obs_profile", phase_obs_profile, g, path, "xl_k", F_kb)
        del F_kb
        del g, res
        run("kb_odd", phase_kb_odd)
        run("kb_parity", phase_kb_parity, tmp)
    for name in (*RING, "armijo_tail_select"):
        # the odd case's comparisons count toward the kernel's error too
        ring_checks[name].max_abs = max(ring_checks[name].max_abs,
                                        ring_odd_checks[name].max_abs)
        ring_checks[name].max_rel = max(ring_checks[name].max_rel,
                                        ring_odd_checks[name].max_rel)
    # the epilogue's error over vmem_full and the ring phases
    sel = vm_checks["armijo_tail_select"]
    sel.max_abs = max(sel.max_abs, ring_checks["armijo_tail_select"].max_abs)
    sel.max_rel = max(sel.max_rel, ring_checks["armijo_tail_select"].max_rel)
    # the member lookups of the dp = 3 sparse mesh count toward its error
    sp_checks["member_lookup"].max_abs = max(sp_checks["member_lookup"].max_abs,
                                             sm_odd_check.max_abs)
    # the candidate sweep's errors at full and at the sparse cell's shapes
    for attr in ("max_abs", "max_rel"):
        setattr(cand_check, attr, max(getattr(cand_check, attr),
                                      getattr(sp_checks["cand_sweep"], attr)))
    for name, c in kbmesh_odd_checks.items():
        # the window kernels' F_dst, directed and accumulate comparisons
        kb_checks[name].max_abs = max(kb_checks[name].max_abs, c.max_abs)
        kb_checks[name].max_rel = max(kb_checks[name].max_rel, c.max_rel)
    checks.update(kb_checks, member_lookup=sp_checks["member_lookup"],
                  cand_sweep=cand_check, **vm_checks,
                  **{name: ring_checks[name] for name in RING})
    for name, c in twod_odd_checks.items():
        # the kernels on closure-table inputs count toward their errors
        checks[name].max_abs = max(checks[name].max_abs, c.max_abs)
        checks[name].max_rel = max(checks[name].max_rel, c.max_rel)
    times.update(kb_times, **sp_times, **vm_times, **ring_times, cand_sweep=cand_times)
    bnd.update({name: kb_bnd[name] for name in K_BLOCKED}, **sp_bnd, **vm_bnd,
               cand_sweep=cand_bnd,
               **ring_bnd)
    launches = {
        "fused_superstep": main_counts["fused_superstep"],
        "grad_llh_csr": split_counts["grad_llh_csr"],
        "candidates_csr": split_counts["candidates_csr"],
        **{name: kb_counts[COUNTER.get(name, name)] for name in K_BLOCKED},
        "member_lookup": sparse_counts["member_lookup"],
        "cand_sweep": sparse_counts["cand_sweep"],
        "candidate_edge_terms": vmem_counts["candidate_edge_terms"],
        "armijo_tail_select": vmem_counts["armijo_tail_select"],
        **{name: ring_counts[name] for name in RING},
    }
    emit({"phase": "side_by_side", "kernels": SIDE} if AGAINST else
         {"phase": "side_by_side", "skipped": "no --against DIR=KERNELS given"})
    emit({"kernels": [
        {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name],
            **({"launches_csr_grouped_kb": kb_split_counts[COUNTER.get(name, name)],
                "launches_resilience_kb": kb_res_counts[COUNTER.get(name, name)],
                "launches_kbmesh_xlk": {tag: mesh_launches(c, name)
                                        for tag, c in kbmesh_counts.items()},
                "launches_tp_full": {tag: mesh_launches(c, name)
                                     for tag, c in tp_full_counts.items()},
                "launches_quality_tp": mesh_launches(q_tp["launches"], name),
                "launches_quality_tp_parity": mesh_launches(
                    q_tp["parity"]["launches"], name),
                "launches_dist_gloo2_xlk_rank0": mesh_launches(
                    dist_counts["gloo2_xlk"], name)}
               if name in K_BLOCKED else {}),
            **({"launches_resilience_full": res_full["a"]["launches"],
                "launches_quality_full": q_full["launches"],
                "launches_quality_parity": {
                    k: v["launches"] for k, v in q_parity["runs"].items()},
                "launches_gexf": gexf_body["launches"],
                "launches_dist_gloo2_full_rank0":
                    dist_counts["gloo2_full"]["fused_superstep"]}
               if name == "fused_superstep" else {}),
            **({"launches_sparse_mesh_full": sm_full_counts[name],
                "launches_sparse_mesh_local": sm_local_counts[name],
                "launches_fleet_full": fleet_body["publication"]["launches"][name]}
               if name in ("member_lookup", "cand_sweep") else {}),
            **({"launches_ring_main": ring_main_counts[name],
                "launches_ring_dp4": ring_counts[name],
                "launches_dist_nccl1": dist_counts["nccl1"][name]}
               if name in (*RING, "armijo_tail_select") else {}),
            **({"launches_twod_full": {tag: mesh_launches(c, name)
                                       for tag, c in twod_full_counts.items()},
                "launches_twod_xlk": {tag: mesh_launches(c, name)
                                      for tag, c in twod_xlk_counts.items()}}
               if name in TWOD_CHECKS else {}),
            "max_abs_err": checks[name].max_abs,
            "max_rel_err": checks[name].max_rel,
            "ms": times[name]["ms"], "kernel_ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": bnd[name]["bound_ms"],
            "bound_by": bnd[name]["bound_by"],
            "library_ms": times[name].get("library_ms"),
            "library_note": LIBRARY_NOTES.get(name, NO_LIBRARY),
        }
        for name in KERNELS
    ], "total_seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
