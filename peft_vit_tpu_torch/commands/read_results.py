"""Results summarizer (counterpart of ``peft_vit_tpu/commands/read_results.py``).

Globs the run logs under ``--output``, parses the final accuracies and
trainable-parameter counts (``utils.results``), averages over seeds and
prints the per-dataset table.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.results import read_log_results, summarize


def main(argv=None):
    p = argparse.ArgumentParser(description="summarize run logs")
    p.add_argument("--output", default="output")
    p.add_argument("--datasets", nargs="+", required=True)
    p.add_argument("--shots", nargs="+", type=int, default=[5])
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--prefix", default="finetuning")
    args = p.parse_args(argv)

    table = summarize(args.output, args.datasets, args.shots, args.seeds, args.prefix)
    for ds in args.datasets:
        _, nparam = read_log_results(args.output, ds, f"{args.prefix}_")
        row = "  ".join(f"{n}-shot: {table[ds][n]:.2f}" for n in args.shots)
        extra = f" (params: {nparam[0]}M)" if nparam else ""
        print(f"{ds:<40s} {row}{extra}")
    vals = [table[ds][n] for ds in args.datasets for n in args.shots
            if np.isfinite(table[ds][n])]
    if vals:
        print(f"{'AVERAGE':<40s} {np.mean(vals):.2f}")
    return table


if __name__ == "__main__":
    main()
