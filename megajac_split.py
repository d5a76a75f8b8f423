#!/usr/bin/env python3
"""Device time of each of megajac's CUDA kernels, by kernel name.

    python3 megajac_split.py [CHECKOUT]

Builds the megajac kernel library of CHECKOUT (default: the checkout this
script sits in) and times its root-seeded and cold-Newton calls at the
flagship's derivative call (7 x 256 lanes of the mini cheetah, the seeded
states of ``chip_smoke.py``) from torch.profiler's kernel records.  That
splits a call into its primal and tangent kernels also where one C entry
point launches both, as the port's first megajac did, so that two
checkouts' kernels compare on one card.  Prints the card's name and power
limit, then one JSON line per call.  Needs a CUDA card; exits 2 without
one.
"""

import sys
from pathlib import Path

import chip_smoke as cs

KERNELS = ("megajac_primal_kernel", "megajac_tangent_kernel")
REPS = 3


def kernel_ms(call):
    """Mean device ms per call() of each kernel in KERNELS, after one
    warm-up; None for a kernel with no device time in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
    ms = dict.fromkeys(KERNELS)     # None: no device time recorded
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0))
        for k in KERNELS:
            if k in ev.key and us:
                ms[k] = (ms[k] or 0.0) + us / 1e3 / REPS
    return ms


def main():
    import torch
    if not torch.cuda.is_available():
        print("megajac_split: no CUDA device", file=sys.stderr)
        sys.exit(2)
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else cs.REPO).resolve()
    sys.path.insert(0, str(checkout))
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    dev = torch.device("cuda")
    mc, system, _ = cs.cheetah(dev)
    kd = kernel_data_for_system(system)
    L = cs.JAC_LANES
    gen = torch.Generator(device=dev).manual_seed(3)
    x64, u64 = cs.seeded_states(mc, L, gen, dev, torch.float64)
    x, u = x64.float(), u64.float()
    xn = kd.step(x64, u64).float()
    print(cs.card_line())
    for root in (True, False):
        args = (x, u, xn) if root else (x, u)
        call = lambda: megajac(kd, *args)
        cs.emit({"checkout": str(checkout), "root_seeded": root, "lanes": L,
                 "ms_by_kernel": kernel_ms(call),
                 "ms": cs.cuda_ms(call, REPS)})


if __name__ == "__main__":
    main()
