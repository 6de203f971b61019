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
  vmem_odd  the candidate edge-terms kernel against its plain version on
            the odd graph at K=37 and K=1,100, in edge chunks of 1,000
            (not a multiple of 32, the last one ragged); then on the hub
            graph at K=37 and 1,000 in chunks of 500 with their runs
            (the degree-700 hub split across two chunks), and with each
            chunk's edges shuffled
  host_odd  the dense conductance backend (A@A in float32 on the card)
            against the native exact triangle counts on the hub graph and
            the parity graph
  graph     AGM planted N=300,000, K=1,000, p_in=0.1, numpy rng seed 1,
            written as a SNAP edge list to a temporary directory
  main      the port's `cli fit` entry on the CUDA device at full width on
            that file (`--graph`, text ingest included), conductance init,
            5 iterations, `--out communities.txt`; path `csr_fused`,
            launches counted from 0 around the fit; the native host
            library loaded; the graph, seeding and extract stage seconds
            beside those before the native library and the array writer;
            the file's sha256 equal to that of the plain
            dict writer's file (extract_communities + save_communities)
            for the same F and graph
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
  split     the same graph and init with --csr-fused off (path `csr`),
            2 steps, launches counted from 0 around the fit
  mesh_init the file ingested as `cli fit` reads it and its conductance F0
  full      each kernel against its plain version at the main path's
            shapes (the main fit's final F), and both timed with CUDA
            events: the median of 10 runs, taken as two rounds of 5
            after a warm-up each, in the order plain, kernel, kernel,
            plain; the graph's ladder tiles by the row groups they run;
            kernel C and its float32 plain version against float64 on the
            conductance F0 (errors reported: the tails cancel there)
  sparse_main `cli fit --representation sparse --sparse-m 64` on the same
            file, conductance init, 5 iterations, no --out; path
            `sparse_merge_pallas`, the member-lookup launches counted from
            0 around the fit (2 edge sweeps x chunks x steps); the LLH
            rises; peak device memory and the state's bytes against a
            dense F's
  sparse_full the member-lookup kernel against its plain version over
            every edge of sparse_main's final state (bit for bit), both
            timed as `full` times kernels, and one step timed split into
            the member kernel, the rest of the grad/candidate passes, the
            Armijo update, the support update and the two sumF scatters,
            and traced once with torch.profiler (device busy time, top
            ops and kernels)
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
  sweep_main `cli sweep --min-com 500 --max-com 1000 --div-com 4
            --max-iters 5` on the same file: the grid, at least 2 trained
            Ks, finite LLHs, the seconds per K; path `csr_fused`
  parity    planted N=2,400, K=100: 5 steps on the card (f32 kernels)
            against the port's CPU `xla` path in float64
  sparse_parity the same graph on the sparse path at M=16 and M=100: 5
            steps on the card against the port's CPU float64 sparse path,
            and at M=100 = K against the card's dense `csr_fused` path
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
  sweep_parity `cli sweep` over the grid (50, 100, 3), 5 iterations per K,
            on the card against `--device cpu --dtype float64`: the same
            grid and chosen K (unless a stop ratio lies within 1e-4 of
            ksweep_tol), each K's LLH within 1e-4
  mesh_parity the parity graph: the ring and the all-gather schedules at
            dp = 4 on the card against the port's CPU float64 `xla` at
            dp = 4 and on one device, 5 steps, LLH within 1e-4
  resilience_full (after `full`) `cli fit` at full on `csr_fused`, 6
            iterations, --checkpoint-every 2, --telemetry-dir,
            --health-every 2, --metrics (a): kernel A launched once a step,
            checkpoints at 2, 4 and 6 with their save seconds and bytes,
            health samples at 0, 2, 4, 6, every event valid against the
            schema, sec_per_iter beside main's; the same fit in a
            subprocess killed (SIGKILL, BIGCLAM_FAULTS) at fit.step 4 and
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
  resilience_kb (after kb_full) a NaN at 2 on csr_fused_kb from kb_main's
            F: one rollback, then every launch of the replay on the scaled
            ladder counted (3 window kernels and the node pass a step)

Then one `side_by_side` line (with --against: each named kernel on the
inputs of its timing phase (`full`, `sparse_full`, `vmem_full`,
`ring_full`, `kb_full`; in `kb_full` the gradient also without the fold,
and the dots and the gradient also on the shuffled ids)
under this tree's library and the other one, outputs compared bit for bit
and both timed as `full` times a kernel and its plain version), one
`kernels` line (per kernel: launches on its path, error against the plain
version, kernel / plain time, the card's lower bound for the same work)
and, last, {"ok": true, "device": {...}}. The ring and mesh
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
import statistics
import subprocess
import sys
import tempfile
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
FULL = dict(n=300_000, k=1000, p_in=0.1, seed=1)
ODD = dict(n=400, k=37, blocks=20, p_in=0.3, isolated=5, seed=3)
HUB = dict(n=800, blocks=40, p_in=0.3, degrees=(100, 700), isolated=5, seed=5)
HUB_K = (37, 1000, 1024)
PARITY = dict(n=2400, k=100, p_in=0.3, seed=0)
XLK = dict(n=60_000, k=3000, p_in=0.5, seed=3)
KB_ODD_K = 1100
KB_ODD_KC = 3             # csr_k_block windows that start off 16 bytes
KB_PARITY_KC = 32
SPARSE_M = 64
SPARSE_ODD_M = (5, 37)
SPARSE_SEARCH_K = 1100    # k_pad above the member lookup's table (1,024)
SPARSE_PARITY_M = (16, 100)
VMEM_ODD_K = (37, 1100)
VMEM_ODD_CHUNK = 1000
VMEM_HUB_K = (37, 1000)
VMEM_HUB_CHUNK = 500      # splits the degree-700 hub across two chunks
SWEEP_MAIN = dict(min_com=500, max_com=1000, div_com=4,
                  kset=[500, 594, 706, 839, 997, 1000])
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


def time_ms(fn, reps: int = 5) -> list:
    """CUDA-event times (ms) of `reps` runs of fn() after a warm-up."""
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


def time_pair(kern, plain, reps: int = 5) -> dict:
    """Median CUDA-event times of a kernel and its plain version over
    2 x reps runs each, taken in the order plain, kernel, kernel, plain
    (reps runs after a warm-up each), so that drift on the card hits both
    alike."""
    p = time_ms(plain, reps)
    k = time_ms(kern, reps) + time_ms(kern, reps)
    p += time_ms(plain, reps)
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


def planted_file(cfg, path):
    """Sample an AGM planted graph and write it to `path` as a SNAP edge
    list (each undirected edge once); returns the sampled Graph."""
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    g, _ = sample_planted_graph(
        cfg["n"], cfg["k"], p_in=cfg["p_in"],
        rng=np.random.default_rng(cfg["seed"]),
    )
    np.savetxt(path, np.stack([g.src, g.dst], axis=1)[g.src < g.dst], fmt="%d")
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


def phase_main(g, path, tmp):
    from bigclam_tpu_torch.ops.extraction import extract_communities, save_communities

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
    # the array writer's file against the plain dict writer's for this F
    plain = os.path.join(tmp, "communities_plain.txt")
    t0 = time.perf_counter()
    save_communities(plain, extract_communities(res.F, g))
    plain_s = time.perf_counter() - t0
    sha, sha_plain = file_sha256(cpath), file_sha256(plain)
    if sha != sha_plain:
        raise AssertionError(f"communities.txt {sha} != the plain writer's {sha_plain}")
    size = os.path.getsize(plain)
    os.remove(plain)
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
        "plain_writer": {"sha256_equal": True, "extract_and_save_s": plain_s},
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
    in each of the two edge sweeps (grad/LLH and candidates)."""
    from bigclam_tpu_torch.ops.objective import edge_chunk_bound

    chunk = edge_chunk_bound(sparse_cfg(1, m), m, 4)
    return 2 * -(-e // chunk) * steps


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
    # the passes run two member-lookup sweeps
    step["member_kernel_ms"] = 2 * times["member_lookup"]["ms"]
    step["passes_rest_ms"] = step["passes_ms"] - step["member_kernel_ms"]
    # the step computes sumF twice (before the passes and after Armijo)
    step["other_ms"] = step["step_ms"] - (
        step["support_ms"] + step["passes_ms"] + step["armijo_ms"] + 2 * step["sumF_ms"]
    )
    return check, times, bnd, {
        "kernels": {"member_lookup": {**check.parts, **times["member_lookup"],
                                      **bnd["member_lookup"]}},
        "step": step, "m": m, "n_pad": model.n_pad, "block_b": model.block_b,
        "edge_chunk": edges.chunk,
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
            "seconds_first_k_includes": "ingest, conductance seeding, model build"}


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
    return out


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
    and resumed (b); a NaN injected at 3 and rolled back (c); health every
    10 against 0, the health pack and the snapshot refresh timed (d); peak
    memory with and without the rollback snapshot."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel, clone_state, refresh_state
    from bigclam_tpu_torch.ops import diagnostics as dx
    from bigclam_tpu_torch.ops.fused import fused_superstep
    from bigclam_tpu_torch.ops.linesearch import accept_stats
    from bigclam_tpu_torch.resilience import read_lineage
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    # (a) the uninterrupted fit
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

    # (b) killed in a subprocess after the checkpoint at 4, then resumed
    args_b = res_fit_args(path, d("res_ck_b"), d("res_tel_b"))
    env = dict(os.environ)
    env["BIGCLAM_FAULTS"] = json.dumps(
        {"faults": [{"kind": "kill", "site": "fit.step", "at": RES_KILL_AT}]})
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", "fit", *args_b, "--quiet"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=900,
    )
    killed_s = time.perf_counter() - t0
    if r.returncode != -9 or "FAULT kill" not in r.stderr:
        raise AssertionError(f"the killed fit ended rc {r.returncode}: {r.stderr[-2000:]}")
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
        "a": {
            "kernel_path": out_a["kernel_path"], "llh_history": hist_a,
            "steps": steps_a, "launches": counts_a["fused_superstep"],
            "sec_per_iter": out_a["sec_per_iter"],
            "sec_per_iter_without_saves": (out_a["sec_per_iter"] * steps_a - save_s) / steps_a,
            "main_sec_per_iter": main_out["sec_per_iter"],
            "checkpoint_saves": saves, "checkpoint_save_s": save_s / saves,
            "checkpoint_bytes": archive_bytes, "peak_gb": peak_a,
            "health_samples": health_a, "metrics_lines": metrics_lines,
            "telemetry": tel_a, "stage_seconds": out_a["stage_seconds"],
        },
        "b": {
            "killed_rc": r.returncode, "killed_s": killed_s,
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
        "sparse_merge_pallas": ("member_lookup",),
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
    run("vmem_odd", phase_vmem_odd)
    run("host_odd", phase_host_odd)
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
        split_counts, _ = run("split", phase_split, g, path, tmp, main_hist)
        t0 = time.perf_counter()
        gi, F0 = mesh_init(path)
        emit({"phase": "mesh_init", "seconds": time.perf_counter() - t0,
              "n": gi.num_nodes, "directed_edges": gi.num_directed_edges})
        checks, times, bnd, _ = run("full", phase_full, g, res.F, F0)
        del res
        res_full = run("resilience_full", phase_resilience_full, g, path, tmp, gi,
                       F0, main_out)
        state, sparse_counts, _ = run("sparse_main", phase_sparse_main, g, path)
        sp_check, sp_times, sp_bnd, _ = run("sparse_full", phase_sparse_full, g, state)
        del state
        res, vmem_counts, _ = run("vmem_main", phase_vmem_main, g, path, main_hist)
        vm_checks, vm_times, vm_bnd, _ = run("vmem_full", phase_vmem_full, g, res.F)
        del res
        run("sweep_main", phase_sweep_main, g, path)
        ring_main_counts, _ = run("ring_main", phase_ring_main, g, path, main_hist)
        model, state, ring_counts, _ = run("ring_dp4", phase_ring_dp4, gi, F0,
                                           main_hist)
        ring_checks, ring_times, ring_bnd, _ = run("ring_full", phase_ring_full,
                                                   model, state)
        del model, state
        run("allgather_main", phase_allgather_main, g, path, gi, F0, main_hist)
        run("ring_multi", phase_ring_multi, gi, F0, main_hist)
        del g, gi, F0
        run("parity", phase_parity, tmp)
        run("sparse_parity", phase_sparse_parity, tmp)
        run("vmem_parity", phase_vmem_parity, tmp)
        run("sweep_parity", phase_sweep_parity, tmp)
        run("mesh_parity", phase_mesh_parity, tmp)
        run("resilience_odd", phase_resilience_odd, tmp)

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
    checks.update(kb_checks, member_lookup=sp_check, **vm_checks,
                  **{name: ring_checks[name] for name in RING})
    times.update(kb_times, **sp_times, **vm_times, **ring_times)
    bnd.update({name: kb_bnd[name] for name in K_BLOCKED}, **sp_bnd, **vm_bnd,
               **ring_bnd)
    launches = {
        "fused_superstep": main_counts["fused_superstep"],
        "grad_llh_csr": split_counts["grad_llh_csr"],
        "candidates_csr": split_counts["candidates_csr"],
        **{name: kb_counts[COUNTER.get(name, name)] for name in K_BLOCKED},
        "member_lookup": sparse_counts["member_lookup"],
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
                "launches_resilience_kb": kb_res_counts[COUNTER.get(name, name)]}
               if name in K_BLOCKED else {}),
            **({"launches_resilience_full": res_full["a"]["launches"]}
               if name == "fused_superstep" else {}),
            **({"launches_ring_main": ring_main_counts[name],
                "launches_ring_dp4": ring_counts[name]}
               if name in (*RING, "armijo_tail_select") else {}),
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
