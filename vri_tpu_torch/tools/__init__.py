"""Ports of the JAX package's work-list micro-benchmarks under ``tools/``.

Each module ports one tool and runs as ``python -m
vri_tpu_torch.tools.<name>``: on ``cuda`` unless given ``--device cpu``,
timed with CUDA events (on the CPU with the host clock, through the
kernels' plain versions).  They print the rows and labels of their source
tools; where a TPU stage has no counterpart on the card, the row says
which scalar arithmetic runs instead.

* ``micro_steps`` (``tools/micro_steps.py``), ``micro_worklist``,
  ``micro_attrib``: the template walk (``ops/worklist.template_walk``);
* ``micro_pass1``: the setup walk (``ops/worklist.setup_walk``);
* ``micro_grouped``: the grouped step (``ops/worklist.grouped_step``);
* ``prof_worklist``: the stages of the sorted raster tier (kernel R).
"""

from __future__ import annotations

import argparse
import subprocess
import time


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default): the kernels; cpu: their plain "
                        "versions")
    return p


def device_of(name: str):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "false); pass --device cpu for the plain versions")
    return torch.device(name)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU a note that times are host-clock times of the plain versions."""
    if device.type != "cuda":
        return "CPU: host clock, plain PyTorch versions (no device metric)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def time_ms(fn, iters: int, device) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters
