#!/usr/bin/env python3
"""Hold the sLSTM's gradients on one NVIDIA card to float64 autograd of the
plain loop, output by output, and r's gradient also contracted in float64
from the backward kernel's own dpre.

Run from the root of a checkout: ``python3 slstm_bwd_accuracy.py``.  The
inputs and upstream gradients are those of
``tests/test_torch_cuda.py::test_slstm_scan_bwd_kernel_matches_float64_autograd``
(float32 cases), so each line reads that test's case output by output: the
kernels' error against float64 autograd, the float32 plain loop's own, and
their ratio as ``accuracy_ratio`` takes it (at most 1 passes).  ``dr
(f64 sum)`` is ``dr = sum_{b,t} h_{t-1} (x) dpre_t`` summed in float64 here
from the kernels' hs and dpre (for float32 gates dxg is dpre) and rounded
once to float32, as the wrapper's card route sums it
(``_recurrent_grad_f64``): the two ``dr`` lines should agree, and a single
float32 contraction (the plain backward's) missed at 64 rows.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

#: (B, S, H, hd), float32 gates and weights
CASES = [(64, 16, 2, 64), (5, 100, 4, 192), (2, 50, 4, 192), (8449, 3, 1, 4)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("slstm_bwd_accuracy: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import slstm_scan as kslstm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)

    def grads(fn, xg, r, st):
        ins = [t.detach().requires_grad_(True) for t in (xg, r, *st)]
        hs, fin = fn(ins[0], ins[1], kslstm.SLSTMState(*ins[2:]))
        outs = [hs, *fin]
        rng = np.random.default_rng(3)
        ups = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
            np.float32)).cuda() for o in outs]
        return torch.autograd.grad(
            sum((o * u).sum() for o, u in zip(outs, ups)), ins)

    for B, S, H, hd in CASES:
        rng = np.random.default_rng(S + hd)

        def t32(shape, lo=None, hi=None, std=1.0):
            x = (rng.uniform(lo, hi, shape) if lo is not None
                 else rng.standard_normal(shape) * std)
            return torch.from_numpy(x.astype(np.float32)).cuda()

        D = H * hd
        xg = t32((B, S, 4, D), std=0.5)
        r = t32((4, H, hd, hd), std=0.02)
        st = [t32((B, D), std=0.3), t32((B, D)), t32((B, D), 0.5, 2.0),
              t32((B, D))]
        got = list(grads(kslstm.slstm_scan, xg, r, st))
        plain32 = grads(kslstm.slstm_scan_plain, xg, r, st)
        plain64 = grads(kslstm.slstm_scan_plain, xg.double(), r.double(),
                        [t.double() for t in st])
        hs = kslstm._launch(xg, r, kslstm.SLSTMState(*st), keep=True)[0]
        hp = kslstm._prev_h(st[0].double(), hs.double()).reshape(
            B, S, H, hd)
        dr64 = torch.einsum("bshd,bsghe->ghde", hp, got[0].double().reshape(
            B, S, 4, H, hd)).float()
        names = ["dxg", "dr", "dh0", "dc0", "dn0", "dm0", "dr (f64 sum)"]
        worst = {}
        for name, g, p, w in zip(names, got + [dr64], list(plain32) +
                                 [plain32[1]], list(plain64) + [plain64[1]]):
            err = float((g.double() - w).abs().max())
            own = float((p.double() - w).abs().max())
            ratio = err / (kslstm.ACCURACY * own + kslstm.TOLERANCE["atol"])
            worst[name] = ratio
            print(f"float32 B {B} S {S} {H} heads of {hd}: {name}: error "
                  f"{err:.4g}, the float32 plain loop's {own:.4g}, ratio "
                  f"{ratio:.4f}", flush=True)
        plan = kslstm.bwd_plan(B, H, hd)
        print(f"float32 B {B} S {S} {H} heads of {hd}: accuracy_ratio "
              f"{max(v for k, v in worst.items() if k != names[-1]):.4f}, "
              f"with dr summed in float64 "
              f"{max(v for k, v in worst.items() if k != 'dr'):.4f}; plan "
              f"{plan}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
