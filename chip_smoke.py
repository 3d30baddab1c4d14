"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, engine, models.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``; then
   builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   each, all at once) and prints each one's build time, registers and
   shared memory.
2. Kernels: holds the engine's two CUDA kernels against their plain
   PyTorch versions on the card, at the main path's shapes: 2^22-record
   chunks, 4096 and 64 bins.
   * score_hist with the chunk masses, in one launch, on four inputs: the
     corpus's Beta chunk with 1% -1 sentinels, uniform scores, scores in
     four bins and scores in one bin. Counts exact; sums within
     1e-6 |e| + n 2^-32 of a float64 sum (the kernel's fixed point
     truncates each run below 2^-32) and, on the Beta and uniform chunks,
     within |k - p| <= 4e-3 |p| + 1e-3 of the plain version, whose float32
     scatter-add drifts by up to ~1e-3 relative in a bin holding millions
     of records (where all records fall in a few bins it drifts past that
     bar itself, so float64 decides: `HIST_INPUTS`); masses within
     rel 1e-12 of torch.float64 sums; all bitwise identical across two
     launches.
   * threshold_select: indices exactly equal at tau 0, 0.5, 0.999, 1.01,
     on an empty input and on lengths that are not a multiple of its
     tile; threshold_count (its counting mode) equal to their lengths.
3. Engine at real size: 2^27 scores (about 1,240 hours of 30 fps video,
   one score per frame; 512 MiB of float32), drawn on the card from
   --seed as Beta(0.01, 1) — the paper's synthetic setting — with
   Bernoulli(score) labels kept on the host, in 16 shards with the default
   2^22-record chunks. One RT, one PT (two-stage IS) and one JT query at
   budget 3000, on engines with 1 and with 8 workers: results must be
   identical across worker counts, per-shard counts must equal a plain
   count on the card, and both kernels must have launched on this path
   (score_hist once per chunk, threshold_select at least once per chunk
   per query). Prints achieved recall and precision.
   A small corpus also runs through the card's engine and a CPU engine
   from one corpus state: tau, counts and indices must agree.
4. Times: kernel, plain and library times at a 2^22-record chunk beside
   the card's bound; for score_hist on the Beta, uniform and clustered
   inputs, its call and its launch alone as device time beside three
   `torch.bincount` calls; for threshold_select also its device time
   alone (no read-back) and threshold_count's; engine build and query
   wall times. Then one build at workers 1 and one at 8 under
   torch.profiler, split by step and kernel: exactly one score_hist
   launch a chunk and three device-to-host copies (the masses' one
   read-back and two normalizers); and three builds at each worker count.
5. flash_attention against its plain version on the card, in bf16
   within BF16_ATOL + 2^-7 |plain| each and BF16_FRO_TOL ||plain|| in all
   (sized from a measurement: see the note at the constants), and in
   float32 at atol = rtol = 2e-5 (the JAX package's own tolerance,
   tests/test_kernels.py): smollm-360m's prefill shape (B=4,
   S=4096, H=15, KV=5, dh=64) causal, a ragged S=1000 causal and
   non-causal, a dh=128 MQA case both ways, the scoring shape (B=256,
   S=128), and zamba2-1.2b's shared block at both (H = KV = 32);
   bitwise identical across two launches.
6. The full smollm-360m model (32 layers, d 960, bf16, weights drawn from
   --seed by `model.init`): one prefill at (4, 4096) through
   `make_serve_prefill`, with exactly 32 flash_attention launches; then
   the same tokens through a float32 copy of the weights, once with the
   kernel and once with attention by the plain version: the last
   position's logits must agree within `F32_LOGIT_TOL` of their largest
   magnitude. The bf16 model's own last-position logits, with the kernel
   and with the plain attention, must agree within `BF16_LOGIT_TOL` of
   theirs (sized from a measurement: see the note at the constants).
7. Score, then select: a 2^15-record `make_token_corpus` (128 tokens a
   record, vocab 49152, 2% planted positives) scored by the full model in
   batches of 256 records (32,768 tokens a call, prefill_32k's sequence),
   the scores kept on the card as shards of a `SelectionEngine`, and one
   RT query (gamma 0.9, delta 0.05, budget 3000) labeled by
   `contains_marker`. Its counts must equal a plain count on the card, and
   flash_attention, score_hist and threshold_select must all have launched
   on this path. Prints records/s, tokens/s, the query's wall time, recall
   and the prefill's mfu (model FLOPs over time over 989 TFLOP/s bf16).
   Then one scoring call under torch.profiler: device time by kernel and
   group (flash_attention, matmul, the rest) and the device's busy share.
8. Times of flash_attention at the prefill shape (its row in the kernels
   line) and at the scoring shape and zamba2's prefill and scoring shapes
   (a line each), beside its bound, its plain version and
   `scaled_dot_product_attention` (the yardstick; the port never calls
   it).
9. linear_scan against its plain version on the card, each case labelled
   with the kernel its route launched (`ls_ops.route`: the chunked
   tensor-core kernel for Mamba2's views, the step kernel otherwise, both
   launches counted on that route): zamba2-1.2b's prefill shape (B=4,
   H=64, S=4096, dk=dv=64) and scoring shape (B=256, S=128) in Mamba2
   mode with Zamba2's decay law and layout (B and C shared by the heads,
   the scalar decay per head, as stride-0 views); RWKV6 mode (bonus u) at
   (2, 64, 1024, 64, 64); the reference's (2, 2, 128, 16, 24) in both
   modes; a ragged S = 1000, S = 1 and decays w = 0.05 (below the Pallas
   kernel's log-decay floor) in both modes; for the chunked kernel, S at
   a chunk's edges (63, 64, 65), decays of 1e-6 in the first 8 steps of
   every 16 and near 1 after (where an L taken from a cumulative log
   loses accuracy), decays of exactly 1 at S = 4096, and float32 q and k.
   o and the final state within SCAN_REF_ATOL (the reference's) at the
   reference's shape and SCAN_REL of the largest |output| elsewhere, of
   the plain version, or of the plain recurrence in float64 where
   S >= 1024 (see the note at the constants); bitwise identical across
   two launches.
10. The full zamba2-1.2b model (38 Mamba2 blocks in 6 super-blocks of 6
    and a tail of 2, one shared attention block run 6 times, d 2048, bf16,
    weights drawn from --seed by `model.init`): one prefill at (4, 4096)
    through `make_serve_prefill` with exactly 38 linear_scan (all on the
    chunked route) and 6 flash_attention launches, its mfu
    (`model_flops`); the bf16 model's
    and its float32 copy's last-position logits with both kernels against
    both plain versions (`LOGIT_TOL`); where the bf16 gap comes from:
    each kernel alone by its plain version, and, with no kernel, the plain
    scan computed in float64 and in bf16.
11. Score, then select with zamba2-1.2b: a 2^13-record token corpus
    (vocab 32000) in calls of 256 records, one RT query as in phase 7;
    records/s, mfu, the scores' range and quantiles, and the path's
    launches (38 linear_scan, all on the chunked route, and 6
    flash_attention a call); a profile of
    one scoring call by group (linear_scan, flash_attention, matmul, the
    rest).
12. Times of linear_scan at the prefill shape (its row in the kernels
    line: the chunked kernel) and at the scoring shape (a line), beside
    its bound and its plain version, and the step kernel's on the same
    inputs with w materialized (its route), timed in turns (chunked,
    step, step, chunked). The bound is the larger of the bytes and the
    least operation time over the two forms (the chunked form's TF32 and
    bf16 products on the tensor cores, the step form's float32
    operations); each term is printed. No single PyTorch call computes
    the scan, so its library time is null.
13. Sessions and the live plane at real size, on phase 3's corpus drawn
    again (2^27 Beta(0.01, 1) scores on the card, 16 shards of 2^23,
    2^22-record chunks, 4096 bins, labels on the host). Sessions: an
    engine over the first 12 shards runs 3 RT (gamma 0.9, delta 0.05,
    budget 3000), 2 two-stage PT (gamma `PT_SESSION_GAMMA`) and 1 JT
    (gamma_recall 0.8, stage budget 3000) on keys split from one key, in
    sequence through `run`/`run_joint` at workers 1, then through
    `run_many` at concurrency 1 and None at workers 8 and at concurrency
    2 at workers 1: tau, per-shard counts and indices identical across
    the four; each run's `SessionStats`, threshold_select launches and
    wall. The live plane (launches counted from here): a standing RT
    certified at epoch 0; an RT pinned at epoch 0 and stepped once,
    then shards 12-13 and 14-15 appended through `IngestPlane`, the
    pinned RT equal to its sequential result and score_hist launched
    exactly once per appended chunk; the standing RT's one catch-up
    (`pump`/`settle`) equal to a plain {A >= tau} per shard on the card,
    launching threshold_select once per appended chunk; the appended
    engine's sketch, z, chunk masses, CDFs and RT/PT/JT bit for bit a
    cold build over the 16 shards; `gc_epochs` after each unpin, with
    `torch.cuda.memory_allocated()` falling by at least the freed
    epoch's flat and sketch; a `DriftSentinel` watch (probe 4096, sigma
    4) over 4 shards that triggers on 12 appended Beta(0.01, 2) shards
    (`make_drift_pair_on_device`'s shift) and stays quiet on the 12
    same-law shards of the corpus. Walls (appends, sessions, the phase)
    are printed beside the card's name and power limit.
14. The serving and durability planes at real size, on phase 13's
    corpus, keys and sequential results (a durable root in a temporary
    directory, removed at the end). Served: a `SelectionServer` over the
    first 12 shards (workers 1, tenants 'metered' with a quota and
    'open') answers phase 13's six queries from a pool of 8 client
    threads: tau, per-shard counts and indices equal the sequential
    results, each query's `oracle_calls` at most its sequential one and
    their sum the channel's labels (the channel's shared cache makes
    attribution depend on the schedule), threshold_select launched as
    often as in sequence; `ServerStats.format()` and p50/p99. Durable: a
    server journaling to the root subscribes a standing RT and an
    audited standing RT (sentinel probe 4096, sigma 4) on `BitmaskStore`
    sinks, snapshots, appends shards 12-13 and 14-15 (each journaled
    append's wall and its split: device-to-host copy, `np.save`, CRC32,
    spool write + fsync, journal record + fsync, install) and records
    taus, sink bytes, the tenant's charge and the watch. The same run
    again under `CrashInjector({"post_journal_pre_install": 1})`: the
    second append dies journaled but not installed (the only exception
    caught in the phase), `close(abandon=True)` frees at least the
    engine's flats (`memory_allocated`), and `SelectionServer.restore`
    over the 12 base shards on the card recovers 2 epochs and 2 standing
    queries, launching score_hist once per replayed chunk (8) and
    threshold_select once per appended chunk per standing query in the
    catch-ups (16); taus, sink bytes, charge and the watch's base key and
    last audited epoch equal the uncrashed run's. The restore's wall
    (build, replay, adopt) and the phase's walls are printed beside the
    card's name and power limit.

Each phase prints its wall time as it ends, and the line before the
kernels line sums them.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Optional
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import live  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import binned, queries, sampling  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import (contains_marker,  # noqa: E402
                                        make_beta_on_device,
                                        make_drift_pair_on_device,
                                        make_token_corpus)
from repro_torch.durable import recovery  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as ls_ref  # noqa: E402
from repro_torch.kernels.score_hist import ops as sh_ops  # noqa: E402
from repro_torch.kernels.score_hist import ref as sh_ref  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402
from repro_torch.kernels.threshold_select import ref as ts_ref  # noqa: E402
from repro_torch.launch.serve import make_serve_prefill  # noqa: E402
from repro_torch.models import attention, mamba, transformer  # noqa: E402
from repro_torch.models import model as modellib  # noqa: E402
from repro_torch.serve import SelectionServer  # noqa: E402

DEVICE = "cuda"
CHUNK = 1 << 22
N_RECORDS = 1 << 27
N_SHARDS = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM, TF32 dense on the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM, bf16 dense on the tensor cores
ARCH = "smollm-360m"
ZAMBA = "zamba2-1.2b"
FA_PREFILL = (4, 4096, 15, 5, 64)     # B, S, H, KV, dh: smollm-360m prefill
FA_SCORING = (256, 128, 15, 5, 64)    # the scoring batch
N_CORPUS = 1 << 15                    # token records scored and selected
SEQ_LEN = 128
SCORE_BATCH = 256                     # records a prefill call: 32,768 tokens
N_SCORE_SHARDS = 8
# flash_attention in bf16 against its plain version (phase 5): each output
# within BF16_ATOL + BF16_RTOL |plain|, and the whole within
# BF16_FRO_TOL ||plain|| (Frobenius). The plain version computes in float32
# and rounds once to bf16; the kernel rounds p to bf16 before p·v and
# rounds its output. BF16_RTOL is one bf16 ulp at most (2^-7 of |x|), for
# the two outputs' rounding. p's rounding (2^-9 relative each) is not
# relative to |o| where the products of p and v cancel, so it needs an
# absolute part: over the cases below at --seed 0, 1 and 2, the largest
# |err| - 2^-7 |plain| measured 3.65e-3 (the scoring shape) on an H100
# 80GB HBM3 at 700 W; BF16_ATOL leaves 37% over it. The Frobenius error
# measured 1.9e-3 to 2.4e-3 of ||plain||; about twice that catches a
# systematic error too small for any one output to show. A q·kᵀ scale 1%
# off exceeds the elementwise bar by 0.026; a dropped key tile by up to 3.6.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 5e-3
BF16_FRO_TOL = 5e-3
F32_TOL = 2e-5                 # atol = rtol, the JAX package's own
# Largest |kernel - plain| of the float32 model's last-position logits, as
# a share of their largest magnitude (phase 6). Both runs are float32
# throughout (no TF32), so they differ only in the order of the attention
# sums (the kernel's online softmax against the plain softmax) and in exp2
# against exp: about 1e-6 of the output a layer. Through 32 layers the
# logits measured 9.65e-7 of their largest magnitude on the H100; the
# tolerance is ten times that.
F32_LOGIT_TOL = 1e-5
# The same for the bf16 model (phase 6). bf16 rounds every layer's output,
# so the kernel's and the plain version's roundings differ at a few
# outputs a layer and the difference grows through 32 layers: at --seed 0,
# 1 and 2 it measured 8.2e-3 to 1.04e-2 of the largest |logit| on an H100
# 80GB HBM3 at 700 W, the size of the distance of the bf16 model with
# plain attention from its float32 copy (8.3e-3 to 9.5e-3). The tolerance
# is three times the largest.
BF16_LOGIT_TOL = 3e-2
# The same two bars for zamba2-1.2b (phase 10), kernels (linear_scan and
# flash_attention) against the plain versions, measured at --seed 0, 1 and
# 2 on an H100 80GB HBM3 at 700 W. bf16: 2.38e-2 to 2.86e-2 of the largest
# |logit|. The kernels do not set that gap: with only linear_scan by its
# plain version it is 2.39e-2 to 2.77e-2, with only flash_attention
# 2.18e-2 to 2.60e-2, and the plain model with its scan computed in
# float64 (no kernel; a change of float32 rounding alone) moves 2.40e-2 to
# 3.26e-2 from the plain model. bf16 rounds the hidden state at every
# block, and 44 blocks carry any change at float32 rounding up to such
# roundings, a large share of logits near 4 (the untied head at
# 1/sqrt(d)). No bar below that floor passes a correct path; the bar is
# 1.4 times its largest reading. It cannot tell a scan computed in bf16
# (3.52e-2 to 4.27e-2 from the plain model): phase 9 holds the main path's
# own scan (bf16 B and C, float32 v) at SCAN_REL, and the float32 copy
# holds the model at ZAMBA_F32_LOGIT_TOL. float32: 5.53e-6 to 6.16e-6,
# through 38 Mamba2 blocks and 6 attention runs; the bar is three times
# the largest.
ZAMBA_BF16_LOGIT_TOL = 4.5e-2
ZAMBA_F32_LOGIT_TOL = 2e-5
LOGIT_TOL = {ARCH: (BF16_LOGIT_TOL, F32_LOGIT_TOL),
             ZAMBA: (ZAMBA_BF16_LOGIT_TOL, ZAMBA_F32_LOGIT_TOL)}
# Operations each kernel does per record, counted from its source:
# score_hist compares, clips, scales, converts and takes a square root
# (8) and adds both float64 mass terms (2, counted at the float32 rate:
# the bytes bound it either way); threshold_select compares once.
OPS_PER_RECORD = {"score_hist": 10, "threshold_select": 1}
# score_hist's inputs (phases 2 and 4), each a 2^22-record chunk, and
# whether the plain version's float32 sums are a bar for it. Where every
# record falls in a few bins, the plain float32 scatter-add drifts far
# from the exact sums (a bin of a million records near 0.3 adds each below
# half an ulp of its total), beyond its own bar of 4e-3 |e| + 1e-3; there
# float64 sums alone decide.
HIST_INPUTS = {"beta": True, "uniform": True, "clustered": False,
               "one bin": False}
# The build's wall at workers 1 and 8 on the same corpus when each chunk
# ran its own masses pass and read-back (PERF.md §5, phase 3 then).
SEPARATE_MASSES_BUILD_S = {1: 0.040, 8: 0.089}
LS_PREFILL = (4, 64, 4096, 64, 64)    # B, H, S, dk, dv: zamba2-1.2b prefill
LS_SCORING = (256, 64, 128, 64, 64)   # the scoring batch
FA_ZAMBA = (4, 4096, 32, 32, 64)      # zamba2's shared attention block
FA_ZAMBA_SCORING = (256, 128, 32, 32, 64)
N_ZAMBA_CORPUS = 1 << 13              # token records zamba2 scores
# linear_scan against its plain version (phase 9). At the reference's
# shapes (dk 16 or 8), the reference's own atol = 1e-4
# (tests/test_kernels.py). At dk = dv = 64 the step kernel computes the
# same float32 recurrence step by step and differs only in the order of
# each step's q·S sum; the chunked kernel computes the chunked form with
# split-TF32 products. The bar is SCAN_REL of the largest |output| (o or
# the state), against the plain version, or, where S >= 1024, against the
# plain recurrence in float64 on the card (the float32 plain version
# drifts there as much as the kernels do: 2.1e-7 of the largest |o| at
# the prefill shape, the step kernel 1.4e-7). Over every case below at
# --seed 0, 1 and 2 the step kernel's largest error measured 2.73e-7 of
# the largest |output| (o at the scoring shape, which Mamba2's route now
# gives the chunked kernel) on an H100 80GB HBM3 at 700 W; SCAN_REL is
# 3.7 times that. The chunked kernel's largest error over seeds 0 to 7
# (`check_scan`) measured 4.61e-7 (the state at decays of exactly 1 and
# S = 4096, against the float64 arbiter, from which the float32 plain
# version's state lies 2.2e-6 to 3.4e-6 at seeds 0 to 2) and 4.37e-7
# elsewhere (o at the scoring shape), same card and limit. A step
# dropped or read twice moves o by far more.
SCAN_REF_ATOL = 1e-4
SCAN_REL = 1e-6
# Every kernel's launch counter, by name.
COUNTERS = {"flash_attention": fa_ops.launches,
            "linear_scan": ls_ops.launches,
            "score_hist": sh_ops.launches,
            "threshold_select": ts_ops.launches}


def reset_counts(names) -> None:
    """Set the launch counters of `names` to 0, by route too."""
    for name in names:
        COUNTERS[name].reset()


def scan_routes() -> dict:
    """linear_scan's launches by route since the last reset."""
    return dict(ls_ops.launches.routes)


def check_scan_routes(expected: int, where: str) -> None:
    """Every linear_scan launch since the reset went through the chunked
    kernel, `expected` of them."""
    routes = scan_routes()
    check(routes == {"chunked": expected, "step": 0},
          f"{where}: linear_scan launches by route {routes}, expected "
          f"{expected} chunked")
    print(f"{where}: linear_scan launches by route {routes}")


def check(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless `ok`."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of `fn`, which must not sync: the
    card sleeps while the calls are queued behind it, so CUDA events see
    the device's time alone, not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(name: str, n: int, bytes_moved: int):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the float32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_RECORD[name] * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 -------------------------------------------------------------------

def hist_input(kind: str, chunk: torch.Tensor, g) -> torch.Tensor:
    """A 2^22-record score_hist input: "beta" is `chunk` (the corpus's
    Beta(0.01, 1) scores); "uniform" is uniform on [0, 1); "clustered" puts
    every record in one of four bins of 4096 (and of 64), "one bin" all of
    them in one."""
    u = torch.rand(chunk.numel(), device=chunk.device, generator=g)
    if kind == "beta":
        return chunk
    if kind == "uniform":
        return u
    if kind == "clustered":
        k = torch.tensor([517.0, 1024.0, 2900.0, 4000.0], device=u.device)[
            torch.randint(0, 4, u.shape, device=u.device, generator=g)]
        return (k + 0.25 + 0.5 * u) / 4096
    return (1234.25 + 0.5 * u) / 4096


def check_hist(s: torch.Tensor, bins: int, plain_bar: bool, label: str):
    """score_hist with its masses on `s` against its plain versions and
    float64 sums: counts exact; sums within 1e-6 |e| + n 2^-32 of float64
    (the fixed point truncates each run below 2^-32) and, if `plain_bar`,
    within 4e-3 |p| + 1e-3 of the plain float32 sums; masses within
    rel 1e-12 of torch.float64 sums; all bitwise on a second launch.
    Returns the largest |kernel - plain|."""
    m1 = torch.empty(2, dtype=torch.float64, device=s.device)
    m2 = torch.empty_like(m1)
    got = sh_ops.score_hist(s, bins, masses=m1)
    again = sh_ops.score_hist(s, bins, masses=m2)
    plain = sh_ref.score_hist_ref(s, bins)
    plain_m = sh_ref.chunk_masses_ref(s)
    valid = s >= 0
    a = s.clamp(0.0, 1.0)[valid]
    ids = sh_ref.bin_index(s, bins)[valid]
    exact = [torch.bincount(ids, weights=w, minlength=bins)
             for w in (a.double().sqrt(), a.double())]
    torch.cuda.synchronize()
    what = f"score_hist {label}, {bins} bins"
    check(torch.equal(got[0], plain[0]), f"{what}: counts")
    check(all(torch.equal(x, y) for x, y in zip(got, again))
          and torch.equal(m1, m2), f"{what}: repeat launches differ")
    for k, p, e in zip(got[1:], plain[1:], exact):
        if plain_bar:
            check(bool(((k - p).abs() <= 4e-3 * p.abs() + 1e-3).all()),
                  f"{what}: sums vs plain")
        tol = 1e-6 * e.abs() + s.numel() * 2.0 ** -32
        check(bool(((k.double() - e).abs() <= tol).all()),
              f"{what}: sums vs float64")
    rel = float(((m1 - plain_m).abs() / plain_m.abs()).max())
    check(rel <= 1e-12, f"{what}: masses {rel:.3g} from float64")
    err = max(float((k - p).abs().max()) for k, p in zip(got, plain))
    drift = max(float(((p.double() - e).abs() / (4e-3 * e.abs() + 1e-3))
                      .max()) for p, e in zip(plain[1:], exact))
    print(f"{what}: counts exact, repeat bitwise, max |kernel - plain| "
          f"{err:.6g}, max |kernel - float64| "
          f"{max(float((k.double() - e).abs().max()) for k, e in zip(got[1:], exact)):.6g}, "
          f"masses {rel:.3g} from float64; the plain sums' distance from "
          f"float64 over their bar {drift:.3g}"
          + ("" if plain_bar else " (float64 decides)"))
    return err


def check_kernels(chunk: torch.Tensor, g) -> dict:
    """Phase 2: each kernel against its plain version; returns each
    kernel's largest |kernel - plain| (score_hist's where the plain sums
    are a bar)."""
    errs = {"score_hist": 0.0}
    for kind, plain_bar in HIST_INPUTS.items():
        s = hist_input(kind, chunk, g)
        for bins in (4096, 64):
            err = check_hist(s, bins, plain_bar, kind)
            if plain_bar:
                errs["score_hist"] = max(errs["score_hist"], err)
    for n, tau in [(CHUNK, tau) for tau in (0.0, 0.5, 0.999, 1.01)] + [
            (n, 0.3) for n in (0, 1000, 5000, CHUNK - 1)]:
        part = chunk[:n]
        got = ts_ops.threshold_select(part, tau)
        want = ts_ref.threshold_select_ref(part, tau)
        count = ts_ops.threshold_count(part, tau)
        check(torch.equal(got, want), f"threshold_select n={n} tau={tau}")
        check(int(count) == want.numel(), f"threshold_count n={n} tau={tau}")
    errs["threshold_select"] = 0.0
    print("threshold_select: indices exact at tau 0/0.5/0.999/1.01 and "
          "lengths 0/1000/5000/2^22-1; threshold_count equal to their "
          "lengths")
    return errs


# -- phase 3 -------------------------------------------------------------------

QUERIES = [
    ("RT", SUPGQuery(target="recall", gamma=0.9, delta=0.05, budget=3000,
                     method="is")),
    ("PT", SUPGQuery(target="precision", gamma=0.9, delta=0.05,
                     budget=3000, method="is")),
    ("JT", JointSUPGQuery(gamma_recall=0.8, stage_budget=3000)),
]


def run_query(eng, key, oracle, name, q):
    """One query through the user entry point; (selection, wall s)."""
    fn = eng.run_joint if name == "JT" else eng.run
    t0 = time.perf_counter()
    sel = fn(key, oracle, q)
    torch.cuda.synchronize()
    return sel, time.perf_counter() - t0


def same(a, b) -> bool:
    """Equal tau, per-shard counts and indices."""
    return (a.tau == b.tau
            and np.array_equal(a.shard_counts, b.shard_counts)
            and all(np.array_equal(a.indices(i), b.indices(i))
                    for i in range(a.num_shards)))


def plain_counts(eng, sel, name, labels) -> np.ndarray:
    """Per-shard counts by a plain comparison on the card: {A >= tau}
    plus the labeled positives below tau; for JT, the true positives
    among that candidate set."""
    thr = ts_ref.threshold32(sel.tau)
    tau_rt = sel.tau
    pos = sel.sampled_positive_global
    out = []
    for sh, shard in enumerate(eng.shards):
        lo, hi = int(eng.offsets[sh]), int(eng.offsets[sh + 1])
        mine = pos[(pos >= lo) & (pos < hi)] - lo
        below = np.unique(mine[shard[torch.from_numpy(mine).to(shard.device)]
                               .cpu().numpy() < tau_rt])
        if name == "JT":
            cand = torch.nonzero(shard >= thr).flatten().cpu().numpy()
            cand = np.union1d(cand, below)
            out.append(int((labels[lo + cand] > 0.5).sum()))
        else:
            out.append(int((shard >= thr).sum()) + below.size)
    return np.asarray(out, np.int64)


def small_agreement(seed: int) -> None:
    """The card's engine against a CPU engine on one corpus state."""
    scores, labels = make_beta_on_device(600_000, 0.01, 1.0, seed=seed + 1,
                                         device="cpu")
    shards = list(torch.tensor_split(scores, 3))
    oracle = array_oracle(labels)
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 16,
                         device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=DEVICE) as card:
        for name, q in QUERIES:
            a, _ = run_query(cpu, R.PRNGKey(seed), oracle, name, q)
            b, _ = run_query(card, R.PRNGKey(seed), oracle, name, q)
            check(same(a, b), f"card vs cpu engine on a small corpus, {name}")
    print("small corpus (3 x 200,000): card engine == CPU engine for "
          "RT/PT/JT from one corpus state")


def engine_phase(scores, labels, seed):
    """Phase 3: build at workers 1 and 8 and run RT/PT/JT on each."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    oracle = array_oracle(labels)
    truth = labels > 0.5
    results, walls = {}, {}
    for workers in (1, 8):
        t0 = time.perf_counter()
        eng = SelectionEngine(shards, num_bins=4096, workers=workers,
                              clamp_workers=False, device=DEVICE)
        torch.cuda.synchronize()
        walls[f"build_w{workers}"] = time.perf_counter() - t0
        results[workers] = {"engine": eng}
        for name, q in QUERIES:
            sel, wall = run_query(eng, R.PRNGKey(seed), oracle, name, q)
            results[workers][name] = sel
            walls[f"{name}_w{workers}"] = wall
    e1, e8 = results[1]["engine"], results[8]["engine"]
    check(all(torch.equal(x, y) for x, y in zip(e1.sketch, e8.sketch)),
          "sketch differs between workers 1 and 8")
    check(e1._state.z == e8._state.z, "z differs between workers 1 and 8")
    for name, _ in QUERIES:
        a, b = results[1][name], results[8][name]
        check(same(a, b), f"{name} differs between workers 1 and 8")
        check(np.array_equal(a.shard_counts,
                             plain_counts(e1, a, name, labels)),
              f"{name} counts differ from the plain count on the card")
        sel_idx = np.concatenate([e1.offsets[i] + a.indices(i)
                                  for i in range(a.num_shards)])
        print(f"{name}: tau {a.tau:.6g}, selected {a.total_selected}, "
              f"oracle calls {a.oracle_calls}, recall "
              f"{queries.recall_of(sel_idx, truth):.4f}, precision "
              f"{queries.precision_of(sel_idx, truth):.4f}")
    for r in results.values():
        r["engine"].close()
    return results, walls


# -- phase 5 -------------------------------------------------------------------

def plain_attention(q, k, v, causal=True):
    """flash_attention's plain version in the kernel's (B,S,H,dh) layout."""
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal).transpose(1, 2)


def attention_inputs(shape, dtype, g):
    """Standard normal q (B,S,H,dh), k and v (B,S,KV,dh) on the card."""
    b, s, h, kv, dh = shape
    return tuple(torch.randn(b, s, n, dh, generator=g, device=DEVICE)
                 .to(dtype) for n in (h, kv, kv))


def check_flash(seed: int) -> float:
    """Phase 5: the kernel against its plain version; returns the largest
    |kernel - plain| at the prefill shape in bf16."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    cases = [(FA_PREFILL, True), ((2, 1000, 15, 5, 64), True),
             ((2, 1000, 15, 5, 64), False), ((2, 512, 8, 1, 128), True),
             ((2, 512, 8, 1, 128), False), (FA_SCORING, True),
             (FA_ZAMBA, True), (FA_ZAMBA_SCORING, True)]
    err_prefill = 0.0
    for shape, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(shape, dtype, g)
            got = fa_ops.flash_attention(q, k, v, causal=causal)
            again = fa_ops.flash_attention(q, k, v, causal=causal)
            plain = plain_attention(q, k, v, causal).float()
            torch.cuda.synchronize()
            err = (got.float() - plain).abs()
            what = f"flash_attention {shape} {dtype} causal={causal}"
            if dtype == torch.bfloat16:
                excess = float((err - BF16_RTOL * plain.abs()).max())
                fro = float(err.norm() / plain.norm())
                check(excess <= BF16_ATOL and fro <= BF16_FRO_TOL,
                      f"{what}: |err| - 2^-7 |plain| up to {excess:.4g} "
                      f"(tol {BF16_ATOL}), ||err|| / ||plain|| {fro:.4g} "
                      f"(tol {BF16_FRO_TOL})")
                bar = (f"max |err| - 2^-7 |plain| {excess:.6g} (tol "
                       f"{BF16_ATOL}), ||err|| / ||plain|| {fro:.6g} (tol "
                       f"{BF16_FRO_TOL})")
            else:
                check(bool((err <= F32_TOL + F32_TOL * plain.abs()).all()),
                      what)
                bar = f"tol {F32_TOL} abs + rel"
            check(torch.equal(got, again), f"{what}: repeat launches differ")
            print(f"{what}: max |kernel - plain| {float(err.max()):.6g}, "
                  f"{bar}, repeat bitwise")
            if shape == FA_PREFILL and dtype == torch.bfloat16:
                err_prefill = float(err.max())
            del q, k, v, got, again, plain, err
    return err_prefill


# -- phase 6 -------------------------------------------------------------------

def model_flops(cfg, batch: int, seq: int) -> float:
    """Prefill model FLOPs, for the mfu of a prefill.

    Dense: 2 · non-embedding params · tokens, plus causal attention,
    2 · B · H · S² · dh a layer.
    Hybrid (Zamba2): the shared block's weights work at each of its n_super
    runs, so 2 · (L · P_mamba + n_super · P_shared) · tokens; attention
    runs n_super times, 2 · B · H · S² · dh each; and each Mamba2 block's
    scan counts the operations of the step form the port runs, per token
    and head 5 · N · hd (k·v, the decay's multiply-add, q·S's
    multiply-add; the count of linear_scan's bound), float32 operations
    on the CUDA cores counted at the bf16 peak like the rest.
    """
    non_embedding = modellib.count_params_analytic(cfg) \
        - cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    tokens = batch * seq
    attention_runs = cfg.num_layers
    scan = 0.0
    if cfg.block == "mamba":
        attention_runs = cfg.num_layers // cfg.shared_attn_every \
            if cfg.shared_attn_every else 0
        shared = cfg.d_model * cfg.head_dim * (
            2 * cfg.num_heads + 2 * cfg.num_kv_heads) \
            + 3 * cfg.d_model * cfg.d_ff if attention_runs else 0
        non_embedding += (attention_runs - 1) * shared
        n, hd = cfg.ssm_state_dim, cfg.ssm_head_dim
        heads = cfg.d_inner // hd
        scan = 5.0 * n * hd * heads * tokens * cfg.num_layers
    return (2.0 * non_embedding * tokens
            + 2.0 * batch * cfg.num_heads * seq * seq * cfg.head_dim
            * attention_runs + scan)


def init_model(cfg, seed: int):
    """The full-width model, its weights drawn on the card from `seed`."""
    t0 = time.perf_counter()
    model = modellib.init(cfg, generator=torch.Generator(device=DEVICE)
                          .manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {n_params} parameters "
          f"({cfg.dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return model


# The model's kernels: where each is looked up, and its plain version.
PLAIN = {"flash_attention": (attention, plain_attention),
         "linear_scan": (mamba, ls_ref.linear_scan_ref)}


@contextlib.contextmanager
def plain_paths(names=tuple(PLAIN), scan=ls_ref.linear_scan_ref):
    """The model's kernels of `names` swapped for their plain versions
    (linear_scan for `scan`); fails if one of them launches meanwhile."""
    before = {name: COUNTERS[name].count for name in names}
    with contextlib.ExitStack() as stack:
        for name in names:
            module, plain = PLAIN[name]
            stack.enter_context(mock.patch.object(
                module, name, scan if name == "linear_scan" else plain))
        yield
    torch.cuda.synchronize()
    check(all(COUNTERS[name].count == n for name, n in before.items()),
          f"a plain run of {names} launched its kernel")


def bf16_gap_sources(model, tokens, names, kernels, plain, scale) -> None:
    """Where the bf16 model's kernels-vs-plain gap comes from, as shares
    of the largest |logit|: each kernel alone swapped for its plain
    version, against the kernels; then, with no kernel at all, the plain
    model with its scan computed in float64 (a change of float32 rounding
    alone, the size of the scan kernel's: how far bf16 carries any such
    change) and in bf16 (a scan computed in bf16), against the plain
    model."""
    for name in names:
        with plain_paths((name,)):
            got = modellib.last_logits(model, tokens)
        print(f"bf16 model, only {name} by its plain version: max "
              f"|difference from the kernels| "
              f"{float((got - kernels).abs().max()) / scale:.3g} of the "
              f"largest |logit|")
    for label, dtype in (("float64", torch.float64),
                         ("bf16", torch.bfloat16)):
        with plain_paths(scan=functools.partial(ls_ref.linear_scan_ref,
                                                compute_dtype=dtype)):
            got = modellib.last_logits(model, tokens)
        check(bool(torch.isfinite(got).all()), f"{label} scan logits")
        print(f"bf16 model, plain versions with the scan computed in "
              f"{label}: max |difference from the plain model| "
              f"{float((got - plain).abs().max()) / scale:.3g} of the "
              f"largest |logit|")


def model_phase(model, cfg, seed: int, per_prefill: dict) -> None:
    """Phases 6 and 10: one full-width prefill through
    `make_serve_prefill`, launching each kernel of `per_prefill` exactly
    that often; then the bf16 model and its float32 copy, each with the
    kernels against the plain versions."""
    bf16_tol, f32_tol = LOGIT_TOL[cfg.name]
    b, s = FA_PREFILL[:2]
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device=DEVICE,
                           generator=torch.Generator(device=DEVICE)
                           .manual_seed(seed + 1))
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens[:, :128]})      # warm-up
    torch.cuda.synchronize()

    reset_counts(per_prefill)
    t0 = time.perf_counter()
    scores = serve_prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: COUNTERS[name].count for name in per_prefill}
    check(launches == per_prefill,
          f"one prefill of {cfg.name} launched {launches}, expected "
          f"{per_prefill}")
    check(scores.shape == (b,) and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()),
          f"prefill scores {scores}")
    mfu = model_flops(cfg, b, s) / wall / BF16_OPS_PER_S
    print(f"{cfg.name} prefill ({b}, {s}) through make_serve_prefill: "
          f"{wall:.4f} s, {b * s / wall:.1f} tokens/s, mfu {mfu:.4f}, "
          f"launches {launches}, scores {scores.tolist()}")
    if "linear_scan" in per_prefill:
        check_scan_routes(per_prefill["linear_scan"], "the prefill")

    # The bf16 model itself: its last-position logits with the kernels
    # against the same model with the plain versions.
    bf16_kernel = modellib.last_logits(model, tokens)
    with plain_paths():
        bf16_plain = modellib.last_logits(model, tokens)
    bf16_diff = float((bf16_kernel - bf16_plain).abs().max())
    bf16_scale = float(bf16_plain.abs().max())
    check(bool(torch.isfinite(bf16_kernel).all())
          and bf16_diff <= bf16_tol * bf16_scale,
          f"{cfg.name} bf16 logits: kernels vs plain differ by {bf16_diff} "
          f"(largest |logit| {bf16_scale})")
    print(f"bf16 model, last-position logits ({b}, {cfg.vocab_size}): "
          f"max |kernels - plain| {bf16_diff:.6g}, largest |logit| "
          f"{bf16_scale:.6g}, ratio {bf16_diff / bf16_scale:.3g} "
          f"(tol {bf16_tol})")
    if len(per_prefill) > 1:
        bf16_gap_sources(model, tokens, per_prefill, bf16_kernel,
                         bf16_plain, bf16_scale)

    f32 = copy.deepcopy(model).float()
    f32.cfg = dataclasses.replace(cfg, dtype="float32")
    with_kernel = modellib.last_logits(f32, tokens)
    with plain_paths():
        with_plain = modellib.last_logits(f32, tokens)
    diff = float((with_kernel - with_plain).abs().max())
    scale = float(with_plain.abs().max())
    check(bool(torch.isfinite(with_kernel).all()) and diff <= f32_tol
          * scale, f"{cfg.name} float32 logits: kernels vs plain differ by "
          f"{diff} (largest |logit| {scale})")
    print(f"float32 copy, last-position logits ({b}, {cfg.vocab_size}): "
          f"max |kernels - plain| {diff:.6g}, largest |logit| "
          f"{scale:.6g}, ratio {diff / scale:.3g} (tol {f32_tol})")
    rounding = float((bf16_plain - with_plain).abs().max()) / scale
    print(f"bf16 model with the plain versions against its float32 copy: "
          f"max |difference| {rounding:.3g} of the largest |logit|")
    del f32, with_kernel, with_plain, bf16_kernel, bf16_plain


# -- phase 7 -------------------------------------------------------------------

def score_select_phase(model, cfg, seed: int, n_corpus: int,
                       per_call: dict) -> dict:
    """Phases 7 and 11: score a token corpus of `n_corpus` records with
    the full model, launching each kernel of `per_call` that often a
    call, and select on the card; returns the path's launch counts."""
    tokens_np, labels = make_token_corpus(n_corpus, SEQ_LEN, cfg.vocab_size,
                                          0.02, seed)
    check(np.array_equal(labels > 0.5, contains_marker(tokens_np)),
          "corpus labels are not the marker oracle")
    tokens = torch.from_numpy(tokens_np).to(DEVICE)
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens[:SCORE_BATCH]})   # warm-up
    torch.cuda.synchronize()

    path = (*per_call, "score_hist", "threshold_select")
    reset_counts(path)
    t0 = time.perf_counter()
    scores = torch.cat([serve_prefill(model,
                                      {"tokens": tokens[i:i + SCORE_BATCH]})
                        for i in range(0, n_corpus, SCORE_BATCH)])
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    check(scores.shape == (n_corpus,) and bool(torch.isfinite(scores).all())
          and bool(((scores >= 0) & (scores <= 1)).all()),
          "corpus scores are not finite probabilities")
    t0 = time.perf_counter()
    name, q = QUERIES[0]
    with SelectionEngine(list(scores.tensor_split(N_SCORE_SHARDS)),
                         num_bins=4096, device=DEVICE) as eng:
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        sel, t_query = run_query(eng, R.PRNGKey(seed), array_oracle(labels),
                                 name, q)
        launches = {k: COUNTERS[k].count for k in path}
        check(np.array_equal(sel.shard_counts,
                             plain_counts(eng, sel, name, labels)),
              "scored corpus: RT counts differ from the plain count")
        sel_idx = np.concatenate([eng.offsets[i] + sel.indices(i)
                                  for i in range(sel.num_shards)])
    n_calls = n_corpus // SCORE_BATCH
    for k, n in per_call.items():
        check(launches[k] == n_calls * n,
              f"{k} launched {launches[k]} times for {n_calls} prefills of "
              f"{cfg.name}, expected {n} each")
    check(launches["score_hist"] >= N_SCORE_SHARDS
          and launches["threshold_select"] >= N_SCORE_SHARDS,
          f"engine kernels did not launch on the scored corpus: {launches}")
    truth = labels > 0.5
    mfu = model_flops(cfg, n_corpus, SEQ_LEN) / t_score / BF16_OPS_PER_S
    quantiles = torch.quantile(scores.double(), torch.tensor(
        [0.01, 0.5, 0.99], dtype=torch.float64, device=DEVICE)).tolist()
    print(f"{cfg.name} scored {n_corpus} records x {SEQ_LEN} tokens in "
          f"{t_score:.3f} s: {n_corpus / t_score:.1f} records/s, "
          f"{n_corpus * SEQ_LEN / t_score:.1f} tokens/s, mfu {mfu:.4f}; "
          f"scores in [{float(scores.min()):.4g}, {float(scores.max()):.4g}]"
          f", quantiles 1/50/99% "
          f"{', '.join(f'{x:.4g}' for x in quantiles)}")
    print(f"RT over the scores: build {t_build:.4f} s, query {t_query:.4f} s,"
          f" tau {sel.tau:.6g}, selected {sel.total_selected} of {n_corpus}"
          f" ({int(truth.sum())} positive), oracle calls {sel.oracle_calls},"
          f" recall {queries.recall_of(sel_idx, truth):.4f}, precision "
          f"{queries.precision_of(sel_idx, truth):.4f}")
    print(f"score-then-select path launches: {launches}")
    if "linear_scan" in per_call:
        check_scan_routes(launches["linear_scan"], "scoring")
    return launches


def profile_scoring_call(model, cfg, seed: int, groups: dict) -> None:
    """Device time by kernel over one scoring call (torch.profiler), in
    `groups` (a name for each substring of a kernel's name) and matmuls
    and the rest, and the device's busy share of the call's wall time."""
    tokens = torch.randint(0, cfg.vocab_size, (SCORE_BATCH, SEQ_LEN),
                           device=DEVICE, generator=torch.Generator(
                               device=DEVICE).manual_seed(seed + 2))
    serve_prefill = make_serve_prefill(cfg)
    serve_prefill(model, {"tokens": tokens})
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        serve_prefill(model, {"tokens": tokens})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if not kernels:
        print("profile of one scoring call: the profiler recorded no device "
              "time")
        return
    by_group = {}
    for name, t, _ in kernels:
        low = name.lower()
        group = next((g for key, g in groups.items() if key in low), None)
        if group is None:
            group = ("matmul" if any(w in low for w in
                                     ("gemm", "cutlass", "xmma", "nvjet"))
                     else "other (elementwise, norms, softmax, copies)")
        by_group[group] = by_group.get(group, 0.0) + t
    print(f"profile of one {cfg.name} scoring call ({SCORE_BATCH} x "
          f"{SEQ_LEN} tokens): wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.3f} of the wall), by "
          "group: " + ", ".join(
              f"{g} {t / 1e3:.3f} ms ({t / busy_us:.3f})"
              for g, t in sorted(by_group.items(), key=lambda kv: -kv[1])))
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:10]:
        print(f"  {t / 1e3:9.3f} ms  x{n:<4d} {name[:100]}")


# -- phase 8 -------------------------------------------------------------------

def flash_row(shape, seed: int) -> dict:
    """flash_attention's times at `shape`, bf16 causal, with its bound."""
    b, s, h, kv, dh = shape
    q, k, v = attention_inputs(shape, torch.bfloat16,
                               torch.Generator(device=DEVICE)
                               .manual_seed(seed + 13))
    group = h // kv
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in
                  (q, k.repeat_interleave(group, dim=2),
                   v.repeat_interleave(group, dim=2)))
    ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: plain_attention(q, k, v), 3)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    ops = 2 * 2 * b * h * (s * s / 2) * dh
    moved = 2 * (2 * q.numel() + 2 * k.numel())        # q, o, k, v in bf16
    t_ops = ops / BF16_OPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# -- phase 9 -------------------------------------------------------------------

def scan_inputs(shape, g, *, layout="mamba", bonus=False, w_const=None,
                tiny_early=False, qk_dtype=torch.bfloat16):
    """linear_scan's inputs on the card. ``mamba``: Zamba2's layout and
    law, as `mamba_block` hands them over: B and C (B,S,N) normal in
    `qk_dtype`, shared by the heads as stride-0 views; dt =
    softplus(normal · 0.88) per (b, s, head) (x · W at W's 1/sqrt(d) init
    after an RMSNorm), the decay w = exp(-dt) (A = -1) as a stride-0 view
    over N, or `w_const`, or with `tiny_early` 1e-6 in the first 8 steps
    of every 16 and 1 - 1e-3 · uniform after; v = x · dt, a (B,S,H,hd)
    float32 tensor seen as (B,H,S,hd). ``plain``: the reference test's
    law, contiguous float32: q, k, v normal at scale 0.5, w =
    sigmoid(normal + 2.5) or `w_const`, and with `bonus` u normal at scale
    0.3."""
    b, h, s, dk, dv = shape

    def normal(*size):
        return torch.randn(*size, generator=g, device=DEVICE)
    if layout == "mamba":
        bc = normal(b, s, 2 * dk).to(qk_dtype)
        dt = F.softplus(normal(b, s, h) * 0.88)
        a = torch.exp(-dt) if w_const is None else torch.full_like(dt,
                                                                   w_const)
        if tiny_early:
            near_one = 1 - 1e-3 * torch.rand(b, s, h, generator=g,
                                             device=DEVICE)
            early = (torch.arange(s, device=DEVICE) % 16 < 8)[None, :, None]
            a = torch.where(early, torch.full_like(a, 1e-6), near_one)
        v = (normal(b, s, h, dv) * dt[..., None]).transpose(1, 2)
        return (bc[..., dk:][:, None].expand(b, h, s, dk),
                bc[..., :dk][:, None].expand(b, h, s, dk), v,
                a.transpose(1, 2)[..., None].expand(b, h, s, dk), None)
    q, k = normal(b, h, s, dk) * 0.5, normal(b, h, s, dk) * 0.5
    w = (torch.sigmoid(normal(b, h, s, dk) + 2.5) if w_const is None
         else torch.full((b, h, s, dk), w_const, device=DEVICE))
    u = normal(h, dk) * 0.3 if bonus else None
    return q, k, normal(b, h, s, dv) * 0.5, w, u


def check_scan(seed: int) -> float:
    """Phase 9: linear_scan against its plain version; returns the largest
    |kernel - plain| of o at the prefill shape."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    cases = [("zamba2 prefill", LS_PREFILL, {}),
             ("zamba2 scoring", LS_SCORING, {}),
             ("rwkv6 mode", (2, 64, 1024, 64, 64),
              dict(layout="plain", bonus=True)),
             ("reference shape", (2, 2, 128, 16, 24), dict(layout="plain")),
             ("reference shape", (2, 2, 128, 16, 24),
              dict(layout="plain", bonus=True)),
             ("ragged S", (2, 16, 1000, 64, 64), {}),
             ("ragged S", (2, 16, 1000, 64, 64),
              dict(layout="plain", bonus=True)),
             ("S = 1", (3, 16, 1, 64, 64), {}),
             ("S = 1", (3, 16, 1, 64, 64), dict(layout="plain", bonus=True)),
             ("w = 0.05", (2, 16, 512, 64, 64), dict(w_const=0.05)),
             ("w = 0.05", (2, 16, 512, 64, 64),
              dict(layout="plain", bonus=True, w_const=0.05)),
             ("S = c - 1", (2, 16, 63, 64, 64), {}),
             ("S = c", (2, 16, 64, 64, 64), {}),
             ("S = c + 1", (2, 16, 65, 64, 64), {}),
             ("w = 1e-6 early in each chunk, near 1 after",
              (2, 16, 512, 64, 64), dict(tiny_early=True)),
             ("w = 1", (2, 16, 4096, 64, 64), dict(w_const=1.0)),
             ("float32 q and k", (2, 16, 1000, 64, 64),
              dict(qk_dtype=torch.float32))]
    err_prefill = 0.0
    for label, shape, kw in cases:
        q, k, v, w, u = scan_inputs(shape, g, **kw)
        route = ls_ops.route(q, k, v, w, u)
        reset_counts(("linear_scan",))
        got = ls_ops.linear_scan(q, k, v, w, u)
        again = ls_ops.linear_scan(q, k, v, w, u)
        check(scan_routes()[route] == 2 == ls_ops.launches.count,
              f"linear_scan {label}: launches by route {scan_routes()}, "
              f"expected 2 {route}")
        plain = ls_ref.linear_scan_ref(q, k, v, w, u)
        long = shape[2] >= 1024
        arbiter = ls_ref.linear_scan_ref(q, k, v, w, u,
                                         compute_dtype=torch.float64) \
            if long else plain
        torch.cuda.synchronize()
        what = (f"linear_scan {label} {shape} "
                f"{'rwkv6 (u)' if u is not None else 'mamba2'} "
                f"{kw.get('layout', 'mamba')} layout, {route} kernel")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{what}: repeat launches differ")
        parts = []
        for part, kern, pl, arb in zip(("o", "state"), got, plain, arbiter):
            err = float((kern.double() - arb.double()).abs().max())
            scale = float(arb.abs().max())
            bar = SCAN_REF_ATOL if shape[3] < 64 else SCAN_REL * scale
            check(bool(torch.isfinite(kern).all()) and err <= bar,
                  f"{what}: {part} differs from the "
                  f"{'float64 ' if long else ''}plain version by {err:.4g} "
                  f"(bar {bar:.4g})")
            line = (f"{part}: max |kernel - plain| "
                    f"{float((kern - pl).abs().max()):.4g}")
            if long:
                line += (f", |kernel - float64| {err:.4g}, |plain - float64|"
                         f" {float((pl.double() - arb).abs().max()):.4g}")
            parts.append(f"{line}, largest |{part}| {scale:.4g}, bar "
                         f"{bar:.4g}")
        print(f"{what}: {'; '.join(parts)}; repeat bitwise")
        if shape == LS_PREFILL:
            err_prefill = float((got[0] - plain[0]).abs().max())
        del q, k, v, w, got, again, plain, arbiter
    return err_prefill


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a (possibly broadcast) view reads."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st) \
        * t.element_size()


SCAN_CHUNK = 64       # steps a chunk of the chunked kernel


def chunked_ms(b, h, s, dk, dv, qk_bf16: bool) -> float:
    """Least tensor-core time of the chunked form: per chunk of n steps,
    (G ∘ L) X over its n(n+1)/2 causal pairs, C S_prev and Bᵀ (dout X)
    over its n steps, each 2 operations a multiply-add, in TF32 times the
    split's products (3 for (G ∘ L) X; 2 for the other two with bf16 q
    and k, 3 with float32); G = C Bᵀ over the causal pairs in bf16 (or
    TF32 with 3 products for float32 q and k)."""
    full, last = divmod(s, SCAN_CHUNK)
    pairs = full * SCAN_CHUNK * (SCAN_CHUNK + 1) // 2 + last * (last + 1) // 2
    qk_split = 2 if qk_bf16 else 3
    tf32 = 3 * 2 * pairs * dv + 2 * qk_split * 2 * s * dk * dv
    g = 2 * pairs * dk
    if qk_bf16:
        return b * h * (tf32 / TF32_OPS_PER_S + g / BF16_OPS_PER_S) * 1e3
    return b * h * (tf32 + 3 * g) / TF32_OPS_PER_S * 1e3


def scan_row(shape, seed: int) -> dict:
    """linear_scan's times at `shape` in Zamba2's layout: the chunked
    kernel (Mamba2's route) and the step kernel on the same inputs with w
    materialized (its route), in turns; with the bound: the larger of the
    bytes (each distinct input element read once, o and the float32 state
    written once) over the HBM rate and the least operation time over the
    two forms (`chunked_ms`; the step form's 5 float32 operations per
    state element a step, k·v, the decay's multiply-add and q·S's, over
    the float32 rate). Prints each term and the step kernel's time, which
    includes reading the materialized w that Mamba2's route never reads
    (its bytes at the HBM rate are printed beside it)."""
    b, h, s, dk, dv = shape
    q, k, v, w, _ = scan_inputs(shape, torch.Generator(device=DEVICE)
                                .manual_seed(seed + 19))
    w_dense = w.contiguous()
    check(ls_ops.route(q, k, v, w) == "chunked"
          and ls_ops.route(q, k, v, w_dense) == "step",
          f"linear_scan routes at {shape}")
    chunked = [cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w), 20)]
    step = [cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w_dense), 20)
            for _ in range(2)]
    chunked.append(cuda_ms(lambda: ls_ops.linear_scan(q, k, v, w), 20))
    ms, step_ms = sum(chunked) / 2, sum(step) / 2
    plain_ms = cuda_ms(lambda: ls_ref.linear_scan_ref(q, k, v, w), 1)
    moved = sum(distinct_bytes(t) for t in (q, k, v, w)) \
        + distinct_bytes(v) + 4 * b * h * dk * dv
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_chunked = chunked_ms(b, h, s, dk, dv, q.dtype == torch.bfloat16)
    t_step = 5 * b * h * s * dk * dv / FP32_OPS_PER_S * 1e3
    t_ops = min(t_chunked, t_step)
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    print(f"linear_scan at (B, H, S, dk, dv) = {shape}, zamba2 layout: "
          f"chunked kernel {ms:.6g} ms ({chunked[0]:.6g}, {chunked[1]:.6g}),"
          f" step kernel {step_ms:.6g} ms ({step[0]:.6g}, {step[1]:.6g}), "
          f"chunked / step {ms / step_ms:.3f}; bound {b_ms:.6g} ms "
          f"({b_by}): bytes {t_bytes:.6g} ms, the chunked form's "
          f"tensor-core operations {t_chunked:.6g} ms, the step form's "
          f"float32 operations {t_step:.6g} ms; share of the bound reached "
          f"{b_ms / ms:.3f} (step kernel {b_ms / step_ms:.3f}); the step "
          f"kernel's time includes reading the dense w, "
          f"{w_dense.numel() * 4 / 1e6:.6g} MB, "
          f"{w_dense.numel() * 4 / HBM_BYTES_PER_S * 1e3:.6g} ms at the HBM "
          f"rate; plain version {plain_ms:.6g} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


# -- phase 4 -------------------------------------------------------------------

def hist_times(chunks, g) -> dict:
    """score_hist per 2^22-record chunk on the Beta corpus (`chunks`),
    uniform and clustered inputs (8 chunks each, cycled): the call (one
    launch with its masses, no read-back), the launch alone as device
    time, the plain versions (the sketch and the masses) and three
    `torch.bincount` calls; prints a line for each input."""
    m = torch.empty(2, dtype=torch.float64, device=chunks[0].device)
    out = {}
    for kind in ("beta", "uniform", "clustered"):
        inputs = [hist_input(kind, c, g) for c in chunks]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % len(inputs)
            return inputs[it["i"]]

        def plain():
            c = nxt()
            return sh_ref.score_hist_ref(c, 4096), sh_ref.chunk_masses_ref(c)

        def library():
            c = nxt()
            valid = c >= 0
            a = c.clamp(0.0, 1.0)
            ids = torch.clamp_max((a * 4096).long(), 4095)
            v = valid.float()
            return (torch.bincount(ids, weights=v, minlength=4096),
                    torch.bincount(ids, weights=a.sqrt() * v, minlength=4096),
                    torch.bincount(ids, weights=a * v, minlength=4096))

        r = out[kind] = {
            "call_ms": cuda_ms(lambda: sh_ops.score_hist(nxt(), 4096,
                                                         masses=m), 50),
            "device_ms": device_ms(lambda: sh_ops.score_hist(nxt(), 4096,
                                                             masses=m), 50),
            "plain_ms": cuda_ms(plain, 5),
            "bincount_ms": cuda_ms(library, 20)}
        print(f"score_hist at a 2^22 chunk, {kind}: call {r['call_ms']:.6g} "
              f"ms (one launch with its masses, no read-back), the launch "
              f"alone {r['device_ms']:.6g} ms of device time; plain "
              f"{r['plain_ms']:.6g} ms; 3 x torch.bincount "
              f"{r['bincount_ms']:.6g} ms; bound "
              f"{(4 * CHUNK + 3 * 4096 * 4 + 16) / HBM_BYTES_PER_S * 1e3:.6g}"
              " ms")
    return out


def build_times(scores, n_chunks: int) -> None:
    """Engine builds over the phase-3 corpus: one at workers 1 and one at
    8 under the profiler (`profile_build`), each with exactly one
    score_hist launch a chunk and three device-to-host copies (the chunk
    masses' one read-back and the two normalizers); then three unprofiled
    builds at each worker count, host clock ending in a synchronize."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    for workers in (1, 8):
        prof = profile_build(shards, workers)
        hist = sum(n for name, n in prof["launches"].items()
                   if "hist_chunk" in name)
        check(hist == n_chunks, f"build at workers {workers}: {hist} "
              f"score_hist launches for {n_chunks} chunks")
        check(prof["d2h"] == 3, f"build at workers {workers}: "
              f"{prof['d2h']} device-to-host copies, expected 3")
    for workers in (1, 8):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SelectionEngine(shards, num_bins=4096, workers=workers,
                            clamp_workers=False, device=DEVICE).close()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"build wall s at workers {workers}: "
              + ", ".join(f"{w:.5f}" for w in walls)
              + " (with a masses pass a chunk: "
              f"{SEPARATE_MASSES_BUILD_S[workers]})")


def kernel_times(flat, tau_rt, g):
    """Per-call times at 2^22-record chunks of the corpus, cycling over 8
    chunks (128 MiB, past the 50 MB L2) so reads come from HBM."""
    chunks = [flat[i * CHUNK:(i + 1) * CHUNK] for i in range(8)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(chunks)
        return chunks[it["i"]]

    hist = hist_times(chunks, g)["beta"]
    thr = torch.tensor(ts_ref.threshold32(tau_rt), device=flat.device)
    k = int((chunks[0] >= thr).sum())
    t = {
        "score_hist": (hist["call_ms"], hist["plain_ms"],
                       hist["bincount_ms"]),
        "threshold_select": (
            cuda_ms(lambda: ts_ops.threshold_select(nxt(), tau_rt), 50),
            cuda_ms(lambda: ts_ref.threshold_select_ref(nxt(), tau_rt), 50),
            cuda_ms(lambda: torch.nonzero(nxt() >= thr), 50)),
    }
    byts = {"score_hist": 4 * CHUNK + 3 * 4096 * 4 + 16,
            "threshold_select": 4 * CHUNK + 8 * k}
    # threshold_select's one launch alone, with no read-back, and
    # threshold_count's memset and launch, both as device time.
    alone = {"kernel_ms": device_ms(
                 lambda: ts_ops._launch(nxt(), tau_rt, count_only=False), 50),
             "count_ms": device_ms(
                 lambda: ts_ops.threshold_count(nxt(), tau_rt), 50),
             "count_call_ms": cuda_ms(
                 lambda: int(ts_ops.threshold_count(nxt(), tau_rt)), 50)}
    print(f"threshold_select at a 2^22 chunk (k = {k} selected): call "
          f"{t['threshold_select'][0]:.6g} ms (one launch, one read-back), "
          f"its launch alone {alone['kernel_ms']:.6g} ms of device time; "
          f"threshold_count {alone['count_ms']:.6g} ms of device time, "
          f"{alone['count_call_ms']:.6g} ms with its read-back; "
          f"torch.nonzero(s >= tau) {t['threshold_select'][2]:.6g} ms; "
          f"bound {byts['threshold_select'] / HBM_BYTES_PER_S * 1e3:.6g} ms")
    return t, byts


def _build_steps():
    """(label, owner, attribute) of each step of an engine build that
    `profile_build` times on the host, where the owner has it."""
    return [("_residency", engine_mod, "_residency"),
            ("chunk pass (_sketch_shards)", SelectionEngine,
             "_sketch_shards"),
            ("per-chunk unit", binned, "chunk_sketch_into"),
            ("score_hist call", sh_ops, "score_hist"),
            # The per-chunk steps of a build before score_hist took over
            # the masses, so that one profile reads an older tree too.
            ("per-chunk unit", binned, "chunk_sketch_stats"),
            ("masses (chunk_raw_masses)", sampling, "chunk_raw_masses"),
            ("merge_sketches", binned, "merge_sketches"),
            ("weight_normalizers", binned, "weight_normalizers"),
            ("_sampling_state", SelectionEngine, "_sampling_state")]


def profile_build(shards, workers: int) -> dict:
    """One engine build over `shards` at `workers` under torch.profiler,
    with host timers on its steps (`_build_steps`: summed over threads, so
    at workers > 1 the per-chunk steps overlap). Prints the build's wall,
    each step's host time and calls, the device time by kernel, the
    device-to-host copies and the device's busy share; returns the wall
    (s) and the kernel launches by name."""
    spent, lock = {}, threading.Lock()

    def timed(label, fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    s, n = spent.get(label, (0.0, 0))
                    spent[label] = (s + time.perf_counter() - t0, n + 1)
        return inner

    patches = [mock.patch.object(owner, attr, timed(label,
                                                    getattr(owner, attr)))
               for label, owner, attr in _build_steps()
               if hasattr(owner, attr)]
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        prof = stack.enter_context(torch.profiler.profile(
            activities=activities))
        t0 = time.perf_counter()
        eng = SelectionEngine(shards, num_bins=4096, workers=workers,
                              clamp_workers=False, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.close()
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    d2h = sum(e.count for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "DtoH" in e.key)
    print(f"build at workers {workers} under the profiler: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / 1e6 / wall:.3f} of the wall), {d2h} device-to-host "
          "copies; host time by step (summed over threads, calls):")
    for label, (s, n) in sorted(spent.items(), key=lambda kv: -kv[1][0]):
        print(f"  {s * 1e3:9.3f} ms  x{n:<4d} {label}")
    print("  device time by kernel:")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {t / 1e3:9.3f} ms  x{n:<4d} {name[:100]}")
    return {"wall_s": wall, "d2h": d2h,
            "launches": {name: n for name, _, n in kernels}}


# -- phase 13 ------------------------------------------------------------------

# A gamma two-stage PT certifies over Beta(0.01, 1) at budget 3000 (at 0.9
# it usually certifies none: PERF.md §7; 0.8 certified in each of six keys
# over 2^23 such records on the CPU).
PT_SESSION_GAMMA = 0.8
SESSION_BATCH = (
    [("RT", SUPGQuery(target="recall", gamma=0.9, delta=0.05,
                      budget=3000))] * 3
    + [("PT", SUPGQuery(target="precision", gamma=PT_SESSION_GAMMA,
                        delta=0.05, budget=3000, two_stage=True))] * 2
    + [("JT", JointSUPGQuery(gamma_recall=0.8, stage_budget=3000))])
SESSION_SHARDS = 12      # the engine's corpus before the appends
SENTINEL_SHARDS = 4      # the sentinel's corpus before its append
DRIFT_SHARDS = 12        # Beta(0.01, 2) shards the sentinel sees appended


def many_with_stats(eng, key, oracle, concurrency):
    """`run_many` over `SESSION_BATCH`; (results, its session's stats,
    threshold_select launches, wall s)."""
    sessions = []
    opened = eng.session

    def spy(*a, **kw):
        sess = opened(*a, **kw)
        sessions.append(sess)
        return sess

    eng.session = spy     # the instance's, to read run_many's session
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    try:
        out = eng.run_many(key, oracle, [q for _, q in SESSION_BATCH],
                           concurrency=concurrency)
        torch.cuda.synchronize()
    finally:
        del eng.session
    return out, sessions[0].stats, ts_ops.launches.count, \
        time.perf_counter() - t0


def check_state_bitwise(a, b, what: str) -> None:
    """Two corpus states hold the same sketches, z, chunk masses and
    chunk-mass CDFs, bit for bit."""
    check(a.z == b.z, f"{what}: z {a.z} != {b.z}")
    for x, y in zip(a.shard_sketches + [a.sketch],
                    b.shard_sketches + [b.sketch]):
        check(all(torch.equal(u, v) for u, v in zip(x, y)),
              f"{what}: a sketch differs")
    for x, y in zip(a.chunk_masses, b.chunk_masses):
        check(all(np.array_equal(u, v) for u, v in zip(x, y)),
              f"{what}: chunk masses differ")
    for k in b.sampling_cache:
        for x, y in zip(a.sampling_cache[k], b.sampling_cache[k]):
            check(x.mass == y.mass and np.array_equal(x.cdf, y.cdf),
                  f"{what}: a chunk-mass CDF differs")


def drift_audit(shards, appended, labels, seed) -> "live.DriftReport":
    """A fresh engine over `shards`, a `DriftSentinel` watch (probe 4096,
    sigma 4) on an RT query, `appended` appended, then one audit."""
    q = SESSION_BATCH[0][1]
    with SelectionEngine(shards, num_bins=4096, device=DEVICE) as eng:
        sent = live.DriftSentinel(eng, array_oracle(labels),
                                  probe_budget=4096, sigma=4.0)
        watch = sent.watch(q, key=R.PRNGKey(seed + 21))
        live.IngestPlane(eng).append(appended)
        return sent.audit(watch, key=R.PRNGKey(seed + 22))


def live_phase(scores, labels, seed, card: str) -> dict:
    """Phase 13: sessions and the live plane at real size. Returns the
    launches of the phase's main path and its walls."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    oracle = array_oracle(labels)
    key = R.PRNGKey(seed + 13)
    keys = R.split(key, len(SESSION_BATCH))
    walls = {}
    print(f"sessions over {SESSION_SHARDS} shards of {shards[0].numel()}: "
          f"3 RT, 2 two-stage PT at gamma {PT_SESSION_GAMMA}, 1 JT "
          "(budget 3000 each)")

    # 1. sessions: sequential at w1, run_many at c1/None on w8, c2 on w1
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    seq = [run_query(eng, k, oracle, name, q)[0]
           for k, (name, q) in zip(keys, SESSION_BATCH)]
    walls["sequential_w1"] = time.perf_counter() - t0
    seq_launches = ts_ops.launches.count
    print(f"sequential run/run_joint at workers 1: wall "
          f"{walls['sequential_w1']:.4f} s, threshold_select launches "
          f"{seq_launches} ({card})")
    with SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096, workers=8,
                         clamp_workers=False, device=DEVICE) as w8:
        check_state_bitwise(w8._state, eng._state,
                            "build at workers 8 vs 1")
        runs = [("w8 concurrency 1", w8, 1), ("w8 concurrency None", w8,
                                              None),
                ("w1 concurrency 2", eng, 2)]
        for label, e, c in runs:
            got, stats, n_ts, wall = many_with_stats(e, key, oracle, c)
            walls[label] = wall
            for (name, _), a, b in zip(SESSION_BATCH, seq, got):
                check(same(a, b), f"run_many {label}: {name} differs from "
                      "the sequential run")
            print(f"run_many {label}: wall {wall:.4f} s, SessionStats "
                  f"rounds {stats.rounds}, drains {stats.drains}, "
                  f"fused_walks {stats.fused_walks}, walk_spans "
                  f"{stats.walk_spans}, fused_spans {stats.fused_spans}; "
                  f"threshold_select launches {n_ts} ({card})")
    for (name, _), sel in zip(SESSION_BATCH, seq):
        print(f"  {name}: tau {sel.tau:.6g}, selected {sel.total_selected}, "
              f"oracle calls {sel.oracle_calls}")
    check(np.isfinite(seq[3].tau), f"PT at gamma {PT_SESSION_GAMMA} "
          "certified no threshold")

    # 2. the live plane, counted from here to the end of the phase
    reset_counts(("score_hist", "threshold_select"))
    plane = live.IngestPlane(eng)
    emitted = []
    sink = pipeline.CallbackSink(lambda sid, idx, folded: emitted.append(
        (sid, np.asarray(idx).copy())))
    rt = SESSION_BATCH[0][1]
    with eng.session(oracle) as sess:
        reg = live.StandingRegistry(plane, sess)
        sq = reg.register(rt, key=R.PRNGKey(seed + 14), sink=sink)
        reg.settle()
        tau_sq = sq.wait_certified(timeout=0)
        emitted.clear()                          # keep the catch-ups only
        pinned = eng.pin()
        h = sess.submit(rt, key=keys[0], state=pinned)
        sess.step()                              # the plan pins epoch 0
        hist0 = sh_ops.launches.count
        appends = []
        for part in (shards[12:14], shards[14:16]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane.append(part)
            torch.cuda.synchronize()
            appends.append(time.perf_counter() - t0)
        hist_appended = sh_ops.launches.count - hist0
        check(same(h.result(), seq[0]), "the RT pinned at epoch 0 differs "
              "from its sequential result after two appends")
        chunks_appended = sum(-(-s.numel() // CHUNK) for s in shards[12:])
        check(hist_appended == chunks_appended,
              f"two appends launched score_hist {hist_appended} times for "
              f"{chunks_appended} appended chunks")
        ts0 = ts_ops.launches.count
        started = reg.pump()
        reg.settle()
        catchup = ts_ops.launches.count - ts0
        check(started == 1 and (sq.emissions, sq.epoch) == (1, 2),
              f"standing RT: {started} catch-ups started, "
              f"{sq.emissions} emissions, epoch {sq.epoch}")
        check(catchup == chunks_appended,
              f"the catch-up launched threshold_select {catchup} times for "
              f"{chunks_appended} appended chunks")
    walls["appends"] = appends
    thr = torch.tensor(ts_ref.threshold32(tau_sq), device=scores.device)
    for sh in range(N_SHARDS):
        mine = [idx for sid, idx in emitted if sid == sh]
        got = np.sort(np.concatenate(mine)) if mine else np.empty(0)
        want = (eng.offsets[sh] + torch.nonzero(eng.shards[sh] >= thr)
                .flatten().cpu().numpy()      # the sink gets global ids
                if sh >= SESSION_SHARDS else np.empty(0))
        check(np.array_equal(got, want), f"standing RT's catch-up on shard "
              f"{sh} differs from a plain count on the card")
    print(f"appends of 2 shards ({2 * shards[0].numel()} records) each: "
          f"wall {', '.join(f'{w:.4f}' for w in appends)} s, score_hist "
          f"launches {hist_appended} for {chunks_appended} appended chunks "
          f"({card})")
    print(f"standing RT (tau {tau_sq:.6g}, certified at epoch 0): one "
          f"catch-up over shards 12-15, {sq.records_reemitted} records, "
          f"threshold_select launches {catchup} for {chunks_appended} "
          "appended chunks; its sink equals a plain count per shard")

    # an engine after the appends == a cold build over the 16 shards
    with SelectionEngine(shards, num_bins=4096, workers=1,
                         device=DEVICE) as cold:
        check_state_bitwise(eng._state, cold._state,
                            "after two appends vs a cold build")
        for k, (name, q) in zip(keys, (SESSION_BATCH[0], SESSION_BATCH[3],
                                       SESSION_BATCH[5])):
            check(same(run_query(eng, k, oracle, name, q)[0],
                       run_query(cold, k, oracle, name, q)[0]),
                  f"{name} after two appends differs from a cold build")
    print("after two appends: sketch, z, chunk masses, CDFs and RT/PT/JT "
          "bit for bit a cold build over the 16 shards")

    # superseded epochs: 1 unpinned, 0 pinned above; each gc frees its own
    for st in (None, pinned):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        if st is not None:
            eng.unpin(st)
            own = st.flat.numel() * 4 + 3 * 4 * eng.num_bins
        else:
            dead = [s for s in eng._superseded if s.pins == 0]
            own = sum(s.flat.numel() * 4 + 3 * 4 * eng.num_bins
                      for s in dead)
            del dead
        freed = eng.gc_epochs()
        torch.cuda.synchronize()
        drop = before - torch.cuda.memory_allocated()
        check(freed == 1 and drop >= own,
              f"gc_epochs freed {freed} epochs, memory_allocated fell "
              f"{drop} bytes, their own {own}")
        print(f"gc_epochs: freed {freed} epoch, memory_allocated fell "
              f"{drop} bytes (its own flat and sketch: {own})")
    del pinned, st
    check(eng.epochs_live == 1 and eng.epochs_freed == 2,
          f"epochs live {eng.epochs_live}, freed {eng.epochs_freed}")
    eng.close()

    # drift sentinel: Beta(0.01, 2) appended trips it, same law does not
    n_drift = DRIFT_SHARDS * shards[0].numel()
    (_, _), (shift, shift_labels) = make_drift_pair_on_device(
        n_drift, seed=seed, device=DEVICE)
    base = SENTINEL_SHARDS * shards[0].numel()
    drift = drift_audit(shards[:SENTINEL_SHARDS],
                        list(shift.tensor_split(DRIFT_SHARDS)),
                        np.concatenate([labels[:base], shift_labels]), seed)
    control = drift_audit(shards[:SENTINEL_SHARDS],
                          shards[SENTINEL_SHARDS:], labels, seed)
    for name, rep, want in (("drift", drift, True),
                            ("control", control, False)):
        print(f"sentinel, {name}: ref rate {rep.ref_rate:.6g}, rate "
              f"{rep.rate:.6g}, z {rep.z:.4f} (sigma 4), drifted "
              f"{rep.drifted}, re-validated {rep.revalidated}")
        check(rep.drifted is want and rep.revalidated is want
              and rep.epoch == 1, f"sentinel on the {name} append: "
              f"drifted {rep.drifted}, z {rep.z}")
    launches = {"score_hist": sh_ops.launches.count,
                "threshold_select": ts_ops.launches.count}
    check(all(n > 0 for n in launches.values()),
          f"phase 13's path launched {launches}")
    print(f"phase 13 live-plane launches: {launches}")
    return {"launches": launches, "walls": walls, "seq": seq,
            "seq_select_launches": seq_launches}


# -- phase 14 ------------------------------------------------------------------

SERVE_CLIENTS = 8        # client threads submitting to the server
SERVE_QUOTA = 10_000     # the metered tenant's label quota (its 3 queries)
PROBE = 4096             # the audited standing RT's sentinel probe
APPEND_SPLIT = (("copy", "device-to-host copy"),
                ("serialize", "np.save into memory"),
                ("crc", "CRC32"),
                ("spool", "spool write + fsync"),
                ("journal", "journal record + fsync"))


@contextlib.contextmanager
def timing_spies(targets):
    """Wrap each (owner, attribute, label) so that every call adds its
    seconds to ``spent[label]``; yields `spent`."""
    spent = dict.fromkeys((label for _, _, label in targets), 0.0)
    with contextlib.ExitStack() as stack:
        for owner, attr, label in targets:
            def wrapped(*a, _fn=getattr(owner, attr), _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    spent[_label] += time.perf_counter() - t0
            stack.enter_context(mock.patch.object(owner, attr, wrapped))
        yield spent


def served_batch(shards, labels, seq, seq_launches, keys, card) -> None:
    """Step 1: the session batch through a `SelectionServer` from a pool of
    client threads, against phase 13's sequential results."""
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    tenants = ["metered" if i % 2 == 0 else "open"
               for i in range(len(SESSION_BATCH))]
    ts_ops.launches.reset()
    t0 = time.perf_counter()
    with SelectionServer(eng, array_oracle(labels), max_inflight=8,
                         quotas={"metered": SERVE_QUOTA}) as server:
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            out = list(pool.map(
                lambda job: server.submit(job[0][1], tenant=job[1],
                                          key=job[2]).result(timeout=600),
                zip(SESSION_BATCH, tenants, keys)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = server.stats()
    launches = ts_ops.launches.count
    for (name, _), a, b in zip(SESSION_BATCH, seq, out):
        check(same(a, b), f"served {name} differs from its sequential run")
        check(b.oracle_calls <= a.oracle_calls,
              f"served {name} charged {b.oracle_calls} labels, alone "
              f"{a.oracle_calls}")
    charged = sum(b.oracle_calls for b in out)
    check(charged == stats.records_labeled,
          f"served queries charged {charged} labels, the channel labeled "
          f"{stats.records_labeled}")
    check(stats.completed == len(SESSION_BATCH) and stats.failed == 0,
          f"server completed {stats.completed}, failed {stats.failed}")
    check(launches == seq_launches, f"served batch launched "
          f"threshold_select {launches} times, in sequence {seq_launches}")
    print(f"served batch ({SERVE_CLIENTS} client threads, tenants "
          f"'metered' (quota {SERVE_QUOTA}) and 'open'): tau, counts and "
          f"indices equal phase 13's sequential results; wall {wall:.4f} s, "
          f"p50 {stats.p50_s:.4f} s, p99 {stats.p99_s:.4f} s, "
          f"threshold_select launches {launches} (in sequence "
          f"{seq_launches}) ({card})")
    print("  oracle_calls served / alone: " + ", ".join(
        f"{name} {b.oracle_calls}/{a.oracle_calls}"
        for (name, _), a, b in zip(SESSION_BATCH, seq, out))
        + f"; served sum {charged} == records labeled "
        f"{stats.records_labeled}")
    print("  " + stats.format().replace("\n", "\n  "))


def quiescent(srv, epoch: int, timeout: float = 300.0) -> None:
    """Wait until every standing query has caught up to `epoch`, every
    sentinel watch has audited it, and nothing is pending."""
    deadline = time.monotonic() + timeout
    while True:
        check(srv._fatal is None, f"server scheduler died: {srv._fatal!r}")
        sqs = srv._registry.standing
        if all(sq.epoch >= epoch and not sq._busy for sq in sqs) \
                and all(w[3] >= epoch for w in srv._watches) \
                and not srv._registry.has_pending():
            return
        check(time.monotonic() < deadline,
              f"standing catch-up to epoch {epoch} stalled")
        time.sleep(0.005)


def served_state(srv, root: pathlib.Path, tag: str) -> dict:
    """What a restore must reproduce: taus, sink bytes, the tenant's
    charge, and each watch's base key and last audited epoch."""
    sqs = srv._registry.standing
    for sq in sqs:
        check(sq.last_error is None and sq.reemit_failures == 0,
              f"{tag}: a standing query failed: {sq.last_error!r}")
    return {"taus": [sq.tau for sq in sqs],
            "sinks": [np.fromfile(sq.sink.path, np.uint8) for sq in sqs],
            "charged": srv.stats().tenants["t"].oracle_charged,
            "watches": [(w[2].tolist(), w[3]) for w in srv._watches]}


def durable_run(shards, labels, root: pathlib.Path, seed: int, tag: str,
                crash_at: Optional[dict], card: str):
    """Steps 2 and 3's server: a standing RT and an audited standing RT
    over the first 12 shards, certified and snapshotted, then shards
    12-13 and 14-15 appended through the journal. With `crash_at` a
    `CrashInjector` kills an append; returns (server, its state or None,
    the injector)."""
    eng = SelectionEngine(shards[:SESSION_SHARDS], num_bins=4096,
                          workers=1, device=DEVICE)
    srv = SelectionServer(eng, array_oracle(labels),
                          durable=root / f"{tag}_durable",
                          quotas={"t": 10**7}, sentinel_probe_budget=PROBE,
                          sentinel_sigma=4.0)
    rt = SESSION_BATCH[0][1]
    for j, audit in enumerate((False, True)):
        # one after the other: the audited RT's reference probe labels
        # nothing a certification still needs, so the tenant's charge
        # does not depend on the schedule
        sq = srv.subscribe(rt, tenant="t", key=R.PRNGKey(seed + 31 + j),
                           sink=pipeline.BitmaskStore(
                               root / f"{tag}_{j}.bits"), audit=audit)
        sq.wait_certified(timeout=300)
    deadline = time.monotonic() + 300
    while not srv._watches:        # the scheduler attaches the watch
        check(time.monotonic() < deadline, f"{tag}: no sentinel watch")
        time.sleep(0.005)
    quiescent(srv, 0)
    srv.snapshot()
    inj = testing.CrashInjector(crash_at or {})
    with inj:
        for part in (shards[12:14], shards[14:16]):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            spies = [(recovery, "_to_host", "copy"), (np, "save",
                                                      "serialize"),
                     (zlib, "crc32", "crc"),
                     (recovery.atomic, "atomic_write_bytes", "spool"),
                     (srv.durable.journal, "append", "journal"),
                     (srv.durable, "record_append", "recorded")]
            with timing_spies(spies) as spent:
                try:
                    epoch = srv.append(part)
                except testing.SimulatedCrash:
                    print(f"{tag}: SimulatedCrash at {inj.fired_at} in the "
                          f"append of epoch {srv.plane.epoch + 1} (journaled, "
                          f"not installed); memory_allocated before it "
                          f"{before} bytes")
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            split = ", ".join(f"{what} {spent[k]:.4f}"
                              for k, what in APPEND_SPLIT)
            print(f"{tag}: journaled append of epoch {epoch} "
                  f"({sum(p.numel() for p in part)} records): wall "
                  f"{wall:.4f} s = record {spent['recorded']:.4f} s ({split}) "
                  f"+ install {wall - spent['recorded']:.4f} s ({card})")
            quiescent(srv, epoch)
    if crash_at:
        check(inj.fired, f"{tag}: the crash at {crash_at} never fired")
        return srv, None, inj
    spool = sum(f.stat().st_size for f in (root / f"{tag}_durable" /
                                           "shards").iterdir())
    print(f"{tag}: {spool} bytes spooled, {srv.durable.journal_bytes} "
          f"journal bytes in {srv.durable.journal_records} records")
    return srv, served_state(srv, root, tag), inj


def restore_run(shards, labels, root: pathlib.Path, want: dict,
                card: str) -> dict:
    """Step 3's restore over the 12 base shards on the card: replay,
    re-adoption and the standing catch-ups, checked against run 2."""
    reset_counts(("score_hist", "threshold_select"))
    marks = {}
    replay = recovery.DurabilityPlane.replay_into

    def timed_replay(self, plane):
        marks["replay"] = (time.perf_counter(), sh_ops.launches.count)
        out = replay(self, plane)
        torch.cuda.synchronize()
        marks["adopt"] = (time.perf_counter(), sh_ops.launches.count)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(recovery.DurabilityPlane, "replay_into",
                           timed_replay):
        srv = SelectionServer.restore(
            root / "crashed_durable", array_oracle(labels),
            base_shards=shards[:SESSION_SHARDS],
            engine_kw={"num_bins": 4096, "workers": 1},
            quotas={"t": 10**7}, sentinel_probe_budget=PROBE,
            sentinel_sigma=4.0)
    t_done = time.perf_counter()
    # resume: re-issue the appends the restored epoch shows missing (the
    # crash came after the journal record, so replay applied both)
    parts = (shards[12:14], shards[14:16])
    reissued = len(parts) - srv.plane.epoch
    for part in parts[srv.plane.epoch:]:
        srv.append(part)
    quiescent(srv, 2)
    torch.cuda.synchronize()
    t_caught = time.perf_counter()
    replayed = marks["adopt"][1] - marks["replay"][1]
    chunks = sum(-(-s.numel() // CHUNK) for s in shards[SESSION_SHARDS:])
    catchups = ts_ops.launches.count
    n_sq = len(srv._registry.standing)
    got = served_state(srv, root, "restored")
    check(srv.engine.device.type == "cuda",
          f"restore built its engine on {srv.engine.device}")
    check(reissued == 0, f"the restored corpus lacks {reissued} appends")
    check((srv.recovered_epochs, srv.recovered_queries) == (2, 2),
          f"recovered {srv.recovered_epochs} epochs, "
          f"{srv.recovered_queries} queries")
    check(replayed == chunks, f"the replay launched score_hist {replayed} "
          f"times for {chunks} replayed chunks")
    check(catchups == chunks * n_sq, f"the catch-ups launched "
          f"threshold_select {catchups} times for {chunks} chunks x "
          f"{n_sq} standing queries")
    check(srv.stats().sentinel_triggers == 0, "the sentinel re-validated")
    check(got["taus"] == want["taus"], f"restored taus {got['taus']} != "
          f"{want['taus']}")
    check(all(np.array_equal(a, b) for a, b in zip(got["sinks"],
                                                   want["sinks"])),
          "restored sink bits differ from the uncrashed run's")
    check(got["charged"] == want["charged"], f"restored tenant charge "
          f"{got['charged']} != {want['charged']}")
    check(got["watches"] == want["watches"], f"restored watch (base key, "
          f"last audited) {got['watches']} != {want['watches']}")
    nxt = [(R.fold_in(np.asarray(k, np.uint32), last + 1).tolist(), last + 1)
           for k, last in got["watches"]]
    print(f"restore: recovered {srv.recovered_epochs} epochs and "
          f"{srv.recovered_queries} standing queries; wall "
          f"{t_done - t0:.4f} s = build {marks['replay'][0] - t0:.4f} + "
          f"replay {marks['adopt'][0] - marks['replay'][0]:.4f} + adopt "
          f"{t_done - marks['adopt'][0]:.4f}; catch-ups done "
          f"{t_caught - t_done:.4f} s later ({card})")
    print(f"restore: score_hist launches in the replay {replayed} for "
          f"{chunks} replayed chunks; threshold_select launches in the "
          f"catch-ups {catchups} ({chunks} chunks x {n_sq} standing "
          f"queries); taus, sink bytes, tenant charge {got['charged']} and "
          f"the watch (base key, last audited epoch) equal the uncrashed "
          f"run's; next audit (key, epoch) {nxt}")
    return {"server": srv, "launches": {"score_hist": sh_ops.launches.count,
                                        "threshold_select": catchups}}


def serve_phase(scores, labels, live: dict, seed: int, card: str) -> dict:
    """Phase 14: the serving and durability planes at real size, on phase
    13's corpus, keys and sequential results."""
    shards = list(torch.tensor_split(scores, N_SHARDS))
    keys = R.split(R.PRNGKey(seed + 13), len(SESSION_BATCH))
    walls = {}
    t0 = time.perf_counter()
    served_batch(shards, labels, live["seq"], live["seq_select_launches"],
                 keys, card)
    walls["served batch"] = time.perf_counter() - t0
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_durable_"))
    try:
        t0 = time.perf_counter()
        srv, want, _ = durable_run(shards, labels, root, seed, "uncrashed",
                                   None, card)
        srv.close()
        walls["uncrashed run"] = time.perf_counter() - t0
        print(f"uncrashed: taus {want['taus']}, tenant charge "
              f"{want['charged']}, watches (base key, last audited) "
              f"{want['watches']}")

        t0 = time.perf_counter()
        srv, _, _ = durable_run(shards, labels, root, seed, "crashed",
                                {"post_journal_pre_install": 1}, card)
        held = sum(st.flat.numel() * 4 for st in
                   [srv.engine._state] + srv.engine._superseded)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        srv.close(abandon=True)
        del srv
        torch.cuda.synchronize()
        after_close = torch.cuda.memory_allocated()
        check(before - after_close >= held, f"close(abandon=True) freed "
              f"{before - after_close} bytes of its engine's {held}")
        restored = restore_run(shards, labels, root, want, card)
        torch.cuda.synchronize()
        after_restore = torch.cuda.memory_allocated()
        restored["server"].close()
        walls["crash, restore, resume"] = time.perf_counter() - t0
        print(f"memory_allocated: {before} bytes before the crashed "
              f"server's close, {after_close} after it (fell "
              f"{before - after_close}, its epochs' flats {held}), "
              f"{after_restore} after the restore")
    finally:
        shutil.rmtree(root)
    launches = restored["launches"]
    check(all(n > 0 for n in launches.values()),
          f"phase 14's path launched {launches}")
    print(f"phase 14 restore-path launches: {launches}")
    print("phase 14 wall s: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in walls.items())
          + f" ({card})")
    return {"launches": launches, "walls": walls}


class Phases:
    """Wall time of each phase, printed as it ends and summed at the end."""

    def __init__(self):
        self.walls = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.walls[name] = time.perf_counter() - t0
        print(f"-- phase {name}: {self.walls[name]:.1f} s")

    def total(self) -> str:
        return ("phase wall s: " + ", ".join(
            f"{k} {v:.1f}" for k, v in self.walls.items())
            + f"; total {sum(self.walls.values()):.1f}")


def main() -> None:
    """Run every phase; exits non-zero on the first failure."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    phase = Phases()

    with phase("build"):
        names = _build.sources()

        def timed_load(name):
            t0 = time.perf_counter()
            _build.load(name)
            return time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            # one nvcc each, all at once
            build_s = dict(zip(names, pool.map(timed_load, names)))
        print(f"built {names}")
        for name in names:
            regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln or "C75" in ln]
            print(f"  {name}: built in {build_s[name]:.1f} s; "
                  f"{'; '.join(regs)}")

    with phase("2-4 engine kernels, engine, times"):
        t0 = time.perf_counter()
        scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0,
                                             seed=args.seed, device=DEVICE)
        torch.cuda.synchronize()
        print(f"corpus: {N_RECORDS} Beta(0.01, 1) scores drawn on the card "
              f"in {time.perf_counter() - t0:.2f} s, positive rate "
              f"{labels.mean():.5f}")

        g = torch.Generator(device=DEVICE).manual_seed(args.seed + 7)
        chunk = scores[:CHUNK].clone()
        chunk[torch.rand(CHUNK, device=DEVICE, generator=g) < 0.01] = -1.0
        errs = check_kernels(chunk, g)
        small_agreement(args.seed)

        sh_ops.launches.reset()
        ts_ops.launches.reset()
        results, walls = engine_phase(scores, labels, args.seed)
        launches = {"score_hist": sh_ops.launches.count,
                    "threshold_select": ts_ops.launches.count}
        n_chunks = results[1]["engine"].plan.total_chunks
        check(launches["score_hist"] >= 2 * n_chunks,
              f"score_hist launched {launches['score_hist']} times for two "
              f"builds of {n_chunks} chunks")
        check(launches["threshold_select"] >= 2 * len(QUERIES) * n_chunks,
              f"threshold_select launched {launches['threshold_select']} "
              "times")
        print(f"main path launches: {launches}")
        print("wall s: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in walls.items()))

        tau_rt = results[1]["RT"].tau
        times, byts = kernel_times(results[1]["engine"]._state.flat, tau_rt,
                                   g)
        build_times(scores, n_chunks)
        del results, scores, chunk

    with phase("5 flash_attention"):
        fa_err = check_flash(args.seed)
    with phase("6-7 smollm-360m prefill, score and select"):
        cfg = get_config(ARCH)
        model = init_model(cfg, args.seed)
        model_phase(model, cfg, args.seed,
                    {"flash_attention": cfg.num_layers})
        fa_launches = score_select_phase(
            model, cfg, args.seed, N_CORPUS,
            {"flash_attention": cfg.num_layers})["flash_attention"]
        profile_scoring_call(model, cfg, args.seed,
                             {"flash_bf16": "flash_attention"})
        del model
    with phase("8 flash_attention times"):
        fa_rows = {shape: flash_row(shape, args.seed)
                   for shape in (FA_PREFILL, FA_SCORING, FA_ZAMBA,
                                 FA_ZAMBA_SCORING)}
        for shape in (FA_SCORING, FA_ZAMBA, FA_ZAMBA_SCORING):
            print(f"flash_attention at (B, S, H, KV, dh) = {shape}, bf16 "
                  f"causal: {json.dumps(fa_rows[shape])}")

    with phase("9 linear_scan"):
        ls_err = check_scan(args.seed)
    with phase("10-11 zamba2-1.2b prefill, score and select"):
        cfg = get_config(ZAMBA)
        n_super = transformer.zamba_layout(cfg)[0]
        per_prefill = {"linear_scan": cfg.num_layers,
                       "flash_attention": n_super}
        model = init_model(cfg, args.seed)
        model_phase(model, cfg, args.seed, per_prefill)
        ls_launches = score_select_phase(model, cfg, args.seed,
                                         N_ZAMBA_CORPUS, per_prefill)[
            "linear_scan"]
        profile_scoring_call(model, cfg, args.seed,
                             {"scan_kernel": "linear_scan",
                              "chunked_kernel": "linear_scan",
                              "flash_bf16": "flash_attention"})
        del model
    with phase("12 linear_scan times"):
        ls_rows = {shape: scan_row(shape, args.seed)
                   for shape in (LS_PREFILL, LS_SCORING)}
        print(f"linear_scan at the scoring shape (B, H, S, dk, dv) = "
              f"{LS_SCORING}, zamba2 layout: "
              f"{json.dumps(ls_rows[LS_SCORING])}")
    live_name = "13 sessions and the live plane"
    with phase(live_name):
        t0 = time.perf_counter()
        scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0,
                                             seed=args.seed, device=DEVICE)
        torch.cuda.synchronize()
        print(f"corpus: phase 3's {N_RECORDS} scores drawn again on the "
              f"card in {time.perf_counter() - t0:.2f} s")
        live = live_phase(scores, labels, args.seed, card)
    print(f"phase 13 wall: {phase.walls[live_name]:.3f} s ({card})")
    serve_name = "14 the server, its journal and restore"
    with phase(serve_name):
        serve_phase(scores, labels, live, args.seed, card)
        del scores, labels, live
    print(f"phase 14 wall: {phase.walls[serve_name]:.3f} s ({card})")
    print(phase.total())

    rows = []
    for name, source, replaces in (
            ("score_hist", "score_hist.cu", "score_hist/score_hist.py:74"),
            ("threshold_select", "threshold_select.cu",
             "threshold_select/threshold_select.py:78")):
        ms, plain_ms, lib_ms = times[name]
        b_ms, b_by = bound(name, CHUNK, byts[name])
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention/"
                             "flash_attention.py:94",
                 "launches": fa_launches, "max_abs_err": fa_err,
                 **fa_rows[FA_PREFILL]})
    rows.append({"name": "linear_scan", "route": "cuda",
                 "source": "src/repro_torch/csrc/linear_scan_chunked.cu",
                 "replaces": "src/repro/kernels/linear_scan/"
                             "linear_scan.py:108",
                 "launches": ls_launches, "max_abs_err": ls_err,
                 **ls_rows[LS_PREFILL]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
