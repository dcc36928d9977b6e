#!/usr/bin/env python3
"""Kernel E's (the planner's Beta bounds') errors against its plain
version, its twin and the CPU, on one NVIDIA card.

    python3 scripts/beta_bounds_errors.py [--n 512] [--seed 17]

For a, b log-uniform over three ranges ([1, 60]: the linear Sessions'
soft counts, 1 + up to 50 sample tuples; [1, 401]: the join trees' pair
samples; [0.5, 1e4]: the wide grid) and q at 1e-6, 1 - 0.95^(1/2), 0.05,
0.5, 0.95 and 1 - 1e-6, it builds E (`csrc/beta_bounds.cu`) from the
checkout, runs both entries on the card and prints one JSON line per
(range, q):

  x_*      the root against the plain version on the card, the twin on
           the card and the plain version on the CPU (max abs)
  fd_*     the four central-difference betainc terms, each against the
           same three, at E's root (max abs)
  grad_*   dI/da and dI/db formed from the terms as the backward forms
           them, (fd0 - fd1) / 2ha and (fd2 - fd3) / 2hb, against the
           same three: max |error| over max |reference| of each
  grad_zero_step, grad_swapped   the same measure for a kernel that left
           out the step (all four terms equal) or swapped + and -: what
           a check must reject
  pdf_rel  the pdf, max relative error over the three
  fd_spread  max |fd0 - fd1|, |fd2 - fd3|: the size of what the terms'
           differences carry

Exits non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

RANGES = ((1.0, 60.0), (1.0, 401.0), (0.5, 1e4))
QS = (1e-6, 1 - 0.95 ** 0.5, 0.05, 0.5, 0.95, 1 - 1e-6)


def grads(fd, a, b):
    from repro_torch.kernels import ref
    ha, hb = ref.grad_steps(a, b)
    return torch.stack([(fd[0] - fd[1]) / (2 * ha),
                        (fd[2] - fd[3]) / (2 * hb)])


def grad_err(got, want) -> float:
    """max |got - want| over max |want|, per derivative, the larger."""
    return max(float((got[i] - want[i]).abs().max()
                     / want[i].abs().max().clamp(min=1e-30))
               for i in range(2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import beta_bounds as BB
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(args.seed)
    for lo, hi in RANGES:
        ab = torch.exp(torch.empty(2, args.n).uniform_(
            math.log(lo), math.log(hi), generator=gen))
        a, b = (t.contiguous().cuda() for t in ab)
        for q in QS:
            qt = torch.full_like(a, q)
            x = BB.beta_incinv(a, b, qt)
            xs = {"plain": ops.beta_incinv(a, b, qt, backend="ref"),
                  "twin": ref.betaincinv_twin(a, b, qt),
                  "cpu": ref.betaincinv_ref(a.cpu(), b.cpu(),
                                            qt.cpu()).cuda()}
            fd, pdf = BB.beta_incinv_grad_terms(a, b, x)
            terms = {
                "plain": ops.beta_incinv_grad_terms(a, b, x, backend="ref"),
                "twin": ref.betaincinv_grad_terms_twin(a, b, x),
                "cpu": [t.cuda() for t in ref.betaincinv_grad_terms_ref(
                    a.cpu(), b.cpu(), x.cpu())]}
            g = grads(fd, a, b)
            want = grads(terms["plain"][0], a, b)
            row = dict(range=[lo, hi], q=q, n=args.n)
            for k in xs:
                row[f"x_{k}"] = float((x - xs[k]).abs().max())
                row[f"fd_{k}"] = float((fd - terms[k][0]).abs().max())
                row[f"grad_{k}"] = grad_err(g, grads(terms[k][0], a, b))
            row["grad_zero_step"] = grad_err(grads(fd[[0, 0, 2, 2]], a, b),
                                             want)
            row["grad_swapped"] = grad_err(grads(fd[[1, 0, 3, 2]], a, b),
                                           want)
            row["pdf_rel"] = max(float(((pdf - t[1]).abs() / t[1]).max())
                                 for t in terms.values())
            row["fd_spread"] = float(torch.maximum(
                (fd[0] - fd[1]).abs(), (fd[2] - fd[3]).abs()).max())
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
