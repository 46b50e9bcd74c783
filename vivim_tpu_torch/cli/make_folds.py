"""Stratified group k-fold creation CLI.

Port of the JAX package's ``cli/make_folds.py`` (the reference's
multiclass_StratKFold.py): walks the raw annotated tree, builds case-level
stratification labels, searches seeds for the most balanced
StratifiedGroupKFold split, writes per-fold trees + split_metadata.csv /
fold_statistics.csv / balance plots.  Host only: pandas, scikit-learn and
matplotlib, no device.

Usage:
  python -m vivim_tpu_torch.cli.make_folds raw_tree Multiclass_Folds
"""

from __future__ import annotations

import argparse

from vivim_tpu_torch.data.folds import make_stratified_group_folds


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_root", type=str,
                   help="raw dataset root (video dirs of annotated frames)")
    p.add_argument("output_root", type=str, default="Multiclass_Folds",
                   nargs="?")
    p.add_argument("--hist_csv", type=str, default=None,
                   help="CSV with clinical_case,histological columns")
    p.add_argument("--n_splits", type=int, default=5)
    p.add_argument("--random_state", type=int, default=42)
    p.add_argument("--n_bins", type=int, default=4)
    p.add_argument("--max_attempts", type=int, default=10)
    p.add_argument("--no_copy", action="store_true",
                   help="write only the index/CSVs, do not copy files")
    args = p.parse_args(argv)
    _, balance, seed = make_stratified_group_folds(
        args.input_root, args.output_root, args.hist_csv, args.n_splits,
        args.random_state, args.n_bins, args.max_attempts,
        copy=not args.no_copy)
    print(f"best seed {seed}; per-fold imbalance:")
    print(balance.to_string(index=False))


if __name__ == "__main__":
    main()
