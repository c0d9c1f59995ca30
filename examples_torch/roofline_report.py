"""Roofline report on the port (``repro_torch``): read the dry-run records
and print, per cell, the three roofline terms, the dominant bottleneck and
the MFU — the Fig. 10 analysis promoted to the multi-pod engine.

The reference reads a folder under ``experiments/``; the port reads the
records ``python -m repro_torch.launch.dryrun`` writes (default
``out/dryrun``, any directory as the argument) through
``repro_torch.launch.roofline_report``, and prints what
``examples/roofline_report.py`` prints over the same records.  The terms
are accounting on ``hw.GPU_H100``'s data-sheet rates, not timings.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out out/dryrun
    PYTHONPATH=src python examples_torch/roofline_report.py [DIR]
"""
import sys

from repro_torch.launch.roofline_report import report


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    print(report(argv[0] if argv else "out/dryrun"))
    print("per-cell optimized variants (rule sets): see EXPERIMENTS.md §Perf "
          "and experiments/hillclimb/")


if __name__ == "__main__":
    main()
