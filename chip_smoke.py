"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, engine, times.

    python3 chip_smoke.py [--seed N]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. Device: prints ``nvidia-smi --query-gpu=name,power.limit``.
2. Kernels: builds every CUDA kernel from ``src/repro_torch/csrc`` (one
   ``nvcc`` each, all at once) and holds each against its plain PyTorch
   version on the card, at the main path's shapes: a 2^22-record chunk
   with 1% -1 sentinels, 4096 and 64 bins.
   * score_hist: counts exact; sums within |k - p| <= 4e-3 |p| + 1e-3 of
     the plain version, whose float32 scatter-add drifts by up to ~1e-3
     relative in a bin holding millions of records; within
     1e-6 |e| + n 2^-32 of a float64 sum (the kernel's fixed point
     truncates each value below 2^-32); bitwise identical across two
     launches.
   * threshold_select: indices exactly equal at tau 0, 0.5, 0.999, 1.01,
     on an empty input and on a length that is not a multiple of 1024.
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
   the card's bound; engine build and query wall times.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import random as R  # noqa: E402
from repro_torch.core import queries  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data.synthetic import make_beta_on_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.score_hist import ops as sh_ops  # noqa: E402
from repro_torch.kernels.score_hist import ref as sh_ref  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402
from repro_torch.kernels.threshold_select import ref as ts_ref  # noqa: E402

DEVICE = "cuda"
CHUNK = 1 << 22
N_RECORDS = 1 << 27
N_SHARDS = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# Operations each kernel does per record, counted from its source:
# score_hist compares, clips, scales, converts and takes a square root
# (8); threshold_select compares once.
OPS_PER_RECORD = {"score_hist": 8, "threshold_select": 1}


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


def bound(name: str, n: int, bytes_moved: int):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the float32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_RECORD[name] * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2 -------------------------------------------------------------------

def check_kernels(chunk: torch.Tensor) -> dict:
    """Phase 2: each kernel against its plain version; returns each
    kernel's largest |kernel - plain|."""
    errs = {}
    for bins in (4096, 64):
        got = sh_ops.score_hist(chunk, bins)
        again = sh_ops.score_hist(chunk, bins)
        plain = sh_ref.score_hist_ref(chunk, bins)
        valid = chunk >= 0
        a = chunk.clamp(0.0, 1.0)[valid]
        ids = sh_ref.bin_index(chunk, bins)[valid]
        exact = [torch.bincount(ids, weights=w, minlength=bins)
                 for w in (a.double().sqrt(), a.double())]
        torch.cuda.synchronize()
        check(torch.equal(got[0], plain[0]), f"score_hist counts, {bins}")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"score_hist repeat launches differ, {bins} bins")
        for k, p, e in zip(got[1:], plain[1:], exact):
            check(bool(((k - p).abs() <= 4e-3 * p.abs() + 1e-3).all()),
                  f"score_hist sums vs plain, {bins} bins")
            tol = 1e-6 * e.abs() + chunk.numel() * 2.0 ** -32
            check(bool(((k.double() - e).abs() <= tol).all()),
                  f"score_hist sums vs float64, {bins} bins")
        err = max(float((k - p).abs().max()) for k, p in zip(got, plain))
        errs["score_hist"] = max(errs.get("score_hist", 0.0), err)
        print(f"score_hist {bins} bins: counts exact, repeat bitwise, "
              f"max |kernel - plain| {err:.6g}, max |kernel - float64| "
              f"{max(float((k.double() - e).abs().max()) for k, e in zip(got[1:], exact)):.6g}")
    for tau in (0.0, 0.5, 0.999, 1.01):
        got = ts_ops.threshold_select(chunk, tau)
        check(torch.equal(got, ts_ref.threshold_select_ref(chunk, tau)),
              f"threshold_select tau={tau}")
    for n in (0, 1000, 5000, CHUNK - 1):
        part = chunk[:n]
        check(torch.equal(ts_ops.threshold_select(part, 0.3),
                          ts_ref.threshold_select_ref(part, 0.3)),
              f"threshold_select length {n}")
    errs["threshold_select"] = 0.0
    print("threshold_select: indices exact at tau 0/0.5/0.999/1.01 and "
          "lengths 0/1000/5000/2^22-1")
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


# -- phase 4 -------------------------------------------------------------------

def kernel_times(flat, tau_rt):
    """Per-call times at 2^22-record chunks of the corpus, cycling over 8
    chunks (128 MiB, past the 50 MB L2) so reads come from HBM."""
    chunks = [flat[i * CHUNK:(i + 1) * CHUNK] for i in range(8)]
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(chunks)
        return chunks[it["i"]]

    def library_hist():
        c = nxt()
        valid = c >= 0
        a = c.clamp(0.0, 1.0)
        ids = torch.clamp_max((a * 4096).long(), 4095)
        v = valid.float()
        return (torch.bincount(ids, weights=v, minlength=4096),
                torch.bincount(ids, weights=a.sqrt() * v, minlength=4096),
                torch.bincount(ids, weights=a * v, minlength=4096))

    thr = torch.tensor(ts_ref.threshold32(tau_rt), device=flat.device)
    k = int((chunks[0] >= thr).sum())
    t = {
        "score_hist": (cuda_ms(lambda: sh_ops.score_hist(nxt(), 4096), 50),
                       cuda_ms(lambda: sh_ref.score_hist_ref(nxt(), 4096),
                               5),
                       cuda_ms(library_hist, 20)),
        "threshold_select": (
            cuda_ms(lambda: ts_ops.threshold_select(nxt(), tau_rt), 50),
            cuda_ms(lambda: ts_ref.threshold_select_ref(nxt(), tau_rt), 50),
            cuda_ms(lambda: torch.nonzero(nxt() >= thr), 50)),
    }
    byts = {"score_hist": 4 * CHUNK + 3 * 4096 * 4,
            "threshold_select": 4 * CHUNK + 8 * k}
    return t, byts


def main() -> None:
    """Run every phase; exits non-zero on the first failure."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    check(torch.cuda.is_available(), "no CUDA device")
    print(device_line())
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    names = _build.sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))      # one nvcc each, all at once
    print(f"built {names} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        regs = [ln.strip() for ln in _build.build_log(name).splitlines()
                if "Used" in ln]
        print(f"  {name}: {'; '.join(regs)}")

    t0 = time.perf_counter()
    scores, labels = make_beta_on_device(N_RECORDS, 0.01, 1.0,
                                         seed=args.seed, device=DEVICE)
    torch.cuda.synchronize()
    print(f"corpus: {N_RECORDS} Beta(0.01, 1) scores drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, positive rate "
          f"{labels.mean():.5f}")

    g = torch.Generator(device=DEVICE).manual_seed(args.seed + 7)
    chunk = scores[:CHUNK].clone()
    chunk[torch.rand(CHUNK, device=DEVICE, generator=g) < 0.01] = -1.0
    errs = check_kernels(chunk)
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
          f"threshold_select launched {launches['threshold_select']} times")
    print(f"main path launches: {launches}")
    print("wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))

    tau_rt = results[1]["RT"].tau
    times, byts = kernel_times(results[1]["engine"]._state.flat, tau_rt)
    sources = {"score_hist": ("src/repro_torch/csrc/score_hist.cu",
                              "src/repro/kernels/score_hist/"
                              "score_hist.py:74"),
               "threshold_select": (
                   "src/repro_torch/csrc/threshold_select.cu",
                   "src/repro/kernels/threshold_select/"
                   "threshold_select.py:78")}
    rows = []
    for name in ("score_hist", "threshold_select"):
        ms, plain_ms, lib_ms = times[name]
        b_ms, b_by = bound(name, CHUNK, byts[name])
        rows.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
