"""flash_attention's kernels in two checkouts, timed in turns on one card.

    python3 tools/flash_ab.py --base DIR [--seed N]

DIR is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a gitignored directory). Each
checkout runs in a process of its own, four in all: base, this tree, this
tree, base. Each builds its kernels from its own ``csrc`` and prints, as
one JSON line, the device time of the bf16 causal forward (o alone, as
scoring and prefill run it) at smollm-360m's and zamba2-1.2b's prefill and
scoring shapes and of the backward at smollm-360m's and
musicgen-medium's training shapes (the backward from the forward's lse
where the checkout keeps one). Device time: the calls are queued behind a
sleep on the card, so the host's speed does not enter. The last line is
the two checkouts' readings side by side with the card's name and power
limit. Needs one card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD_SHAPES = ((4, 4096, 15, 5), (256, 128, 15, 5), (4, 4096, 32, 32),
              (256, 128, 32, 32))
BWD_SHAPES = ((4, 4096, 15, 5), (4, 4096, 24, 24))
REPS = 20


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds a call of `fn`, queued behind a sleep."""
    import torch
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


def worker(tree: pathlib.Path, seed: int) -> None:
    """Time the kernels of the checkout at `tree`; print one JSON line."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device="cuda").manual_seed(seed)

    def inputs(b, s, h, kv):
        return [torch.randn(b, s, n, 64, generator=g, device="cuda")
                .to(torch.bfloat16) for n in (h, kv, kv, h)]

    out = {"tree": str(tree), "fwd_ms": {}, "bwd_ms": {}}
    for shape in FWD_SHAPES:
        q, k, v, _ = inputs(*shape)
        out["fwd_ms"][str(shape)] = device_ms(
            lambda: ops.flash_attention(q, k, v))
    for shape in BWD_SHAPES:
        q, k, v, do = inputs(*shape)
        if hasattr(ops, "flash_attention_fwd"):
            o, lse = ops.flash_attention_fwd(q, k, v)
            kw = {"lse": lse}
        else:
            o, kw = ops.flash_attention(q, k, v), {}
        out["bwd_ms"][str(shape)] = device_ms(
            lambda: ops.flash_attention_bwd(q, k, v, o, do, **kw))
    print(json.dumps(out), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", type=pathlib.Path)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker is not None:
        worker(args.worker, args.seed)
        return
    if args.base is None:
        raise SystemExit("flash_ab: --base DIR is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    readings = {"base": [], "this": []}
    for name, tree in (("base", args.base), ("this", ROOT), ("this", ROOT),
                       ("base", args.base)):
        done = subprocess.run(
            [sys.executable, __file__, "--worker", str(tree.resolve()),
             "--seed", str(args.seed)], capture_output=True, text=True,
            check=False)
        if done.returncode != 0:
            raise SystemExit(f"flash_ab: the {name} run failed:\n"
                             f"{done.stdout}\n{done.stderr}")
        line = json.loads(done.stdout.strip().splitlines()[-1])
        readings[name].append(line)
        print(json.dumps({"run": name, **line}), flush=True)
    side = {}
    for kind in ("fwd_ms", "bwd_ms"):
        for shape in readings["this"][0][kind]:
            side[f"{kind[:3]} {shape}"] = {
                name: [round(r[kind][shape], 4) for r in runs]
                for name, runs in readings.items()}
    print(json.dumps({"card": card, "device_ms": side}))


if __name__ == "__main__":
    main()
