"""Case-level stratified group k-fold splitting.

Copy of the JAX package's ``data/folds.py``; behavioural contract from the
reference's multiclass_StratKFold.py:

- ``gather_annotated_frames`` (:17-52): walk the raw tree for dirs with
  frame.png + any mask; record per-frame mask presence and the top-level
  dir as the clinical case (= group).
- Stratification label (:354-445): histological type (from an optional CSV)
  x frame-count quantile bin (qcut n_bins with fallbacks) x solid-presence
  bin x non-solid-presence bin, joined as a string per case.
- ``StratifiedGroupKFold`` over frames with case groups; ``max_attempts``
  seeds are tried and the split with the lowest mean imbalance score is
  kept (:456-474).  Imbalance score per fold (evaluate_fold_balance,
  :215-330): sum of |split solid/non-solid ratio - overall ratio| over
  train and val.
- Output (:569-637): per-fold ``fold_i/{train,val}/{case}/{item}/`` copied
  trees (``copy=True``) or an index of frame records; ``split_metadata.csv``
  + ``fold_statistics.csv``; balance plots.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np
import pandas as pd


def gather_annotated_frames(input_root) -> pd.DataFrame:
    records = []
    input_root = Path(input_root)
    for dirpath, _, filenames in os.walk(input_root):
        files = {f.lower() for f in filenames}
        if "frame.png" not in files:
            continue
        if not any(m in files for m in
                   ("background.png", "solid.png", "non-solid.png")):
            continue
        d = Path(dirpath)
        rel = d.relative_to(input_root)
        rec = {
            "clinical_case": rel.parts[0],
            "item": rel.as_posix(),
            "frame_path": str(d / "frame.png"),
            "has_background": "background.png" in files,
            "has_solid": "solid.png" in files,
            "has_nonsolid": "non-solid.png" in files,
        }
        rec["background_path"] = (str(d / "background.png")
                                  if rec["has_background"] else None)
        rec["solid_path"] = str(d / "solid.png") if rec["has_solid"] else None
        rec["nonsolid_path"] = (str(d / "non-solid.png")
                                if rec["has_nonsolid"] else None)
        # optional fan-beam mask: carried through the split untouched
        # (multiclass_StratKFold.py:36-50, 615-616; never applied by the
        # reference datasets — the "apply fan" in main_dataset.py:260 is an
        # unimplemented comment)
        rec["has_fan"] = "fan.png" in files
        rec["fan_path"] = str(d / "fan.png") if rec["has_fan"] else None
        records.append(rec)
    return pd.DataFrame(records)


def _safe_qcut(series, q, labels=None):
    """qcut with fallback to a median split when the values cannot support
    the requested bins (constant values yield all-NaN under
    duplicates='drop' in recent pandas, ValueError in older)."""
    lo, hi = (labels if labels is not None and len(labels) == 2 else (0, 1))
    try:
        binned = pd.qcut(series, q=q, labels=labels, duplicates="drop")
        binned = pd.Series(np.asarray(binned.astype(object)),
                           index=series.index)
    except ValueError:
        binned = pd.Series(np.nan, index=series.index, dtype=object)
    if binned.isna().any():
        med = series.median()
        fallback = np.where(series <= med, lo, hi)
        binned = binned.where(binned.notna(), pd.Series(fallback,
                                                        index=series.index))
    return binned


def build_strat_labels(df: pd.DataFrame, hist_df: pd.DataFrame | None = None,
                       n_bins: int = 4) -> pd.DataFrame:
    """Case-level stratification labels (hist x count_bin x solid x nonsolid)."""
    case_df = pd.DataFrame({"clinical_case": df["clinical_case"].unique()})
    if hist_df is not None and "histological" in hist_df.columns:
        case_df = case_df.merge(
            hist_df[["clinical_case", "histological"]], on="clinical_case",
            how="left")
        case_df["histological"] = case_df["histological"].fillna("unknown")
    else:
        case_df["histological"] = "unknown"
    counts = df.groupby("clinical_case").size().rename("frame_count")
    case_df = case_df.join(counts, on="clinical_case")
    case_df["count_bin"] = _safe_qcut(case_df["frame_count"], n_bins)
    presence = df.groupby("clinical_case").agg(
        has_solid=("has_solid", "mean"), has_nonsolid=("has_nonsolid", "mean"))
    case_df = case_df.join(presence, on="clinical_case")
    case_df["solid_bin"] = _safe_qcut(
        case_df["has_solid"], 2, ["low_solid", "high_solid"])
    case_df["nonsolid_bin"] = _safe_qcut(
        case_df["has_nonsolid"], 2, ["low_nonsolid", "high_nonsolid"])
    case_df["strat_label"] = (
        case_df["histological"].astype(str) + "_bin"
        + case_df["count_bin"].astype(str) + "_"
        + case_df["solid_bin"].astype(str) + "_"
        + case_df["nonsolid_bin"].astype(str)).fillna("unknown")
    return case_df.drop_duplicates(subset="clinical_case")


def evaluate_fold_balance(folds, df: pd.DataFrame) -> pd.DataFrame:
    total = max(len(df), 1)
    overall_solid = df["has_solid"].sum() / total
    overall_nonsolid = df["has_nonsolid"].sum() / total
    rows = []
    for fold_idx, (train_idx, val_idx) in enumerate(folds):
        tr, va = df.iloc[train_idx], df.iloc[val_idx]
        tsr = tr["has_solid"].mean() if len(tr) else 0.0
        tnr = tr["has_nonsolid"].mean() if len(tr) else 0.0
        vsr = va["has_solid"].mean() if len(va) else 0.0
        vnr = va["has_nonsolid"].mean() if len(va) else 0.0
        rows.append({
            "fold": fold_idx,
            "train_frames": len(tr),
            "val_frames": len(va),
            "train_solid_ratio": tsr,
            "train_nonsolid_ratio": tnr,
            "val_solid_ratio": vsr,
            "val_nonsolid_ratio": vnr,
            "imbalance_score": (abs(tsr - overall_solid)
                                + abs(tnr - overall_nonsolid)
                                + abs(vsr - overall_solid)
                                + abs(vnr - overall_nonsolid)),
        })
    return pd.DataFrame(rows)


def make_stratified_group_folds(
    input_root,
    output_root,
    hist_csv=None,
    n_splits: int = 5,
    random_state: int = 42,
    n_bins: int = 4,
    max_attempts: int = 10,
    copy: bool = True,
    plots: bool = True,
):
    """Returns (fold index list, balance DataFrame, best seed).

    Fold index: list of dicts {"train": frame-record list, "val": ...}
    where each record carries the source paths; with ``copy=True`` the
    reference's ``fold_i/{train,val}`` copied trees are also produced.
    """
    from sklearn.model_selection import StratifiedGroupKFold

    df = gather_annotated_frames(input_root)
    if df.empty:
        raise ValueError(f"no annotated frames under {input_root}")
    output_root = Path(output_root)
    output_root.mkdir(parents=True, exist_ok=True)
    hist_df = pd.read_csv(hist_csv) if hist_csv else None
    case_df = build_strat_labels(df, hist_df, n_bins)
    y = df["clinical_case"].map(
        case_df.set_index("clinical_case")["strat_label"])
    groups = df["clinical_case"]

    best_folds, best_score, best_seed = None, float("inf"), random_state
    for attempt in range(max_attempts):
        seed = random_state + attempt
        sgkf = StratifiedGroupKFold(n_splits=n_splits, shuffle=True,
                                    random_state=seed)
        folds = list(sgkf.split(df, y=y, groups=groups))
        score = evaluate_fold_balance(folds, df)["imbalance_score"].mean()
        if score < best_score:
            best_folds, best_score, best_seed = folds, score, seed

    balance_df = evaluate_fold_balance(best_folds, df)

    fold_index = []
    for fold_idx, (train_idx, val_idx) in enumerate(best_folds):
        entry = {}
        for split_name, idx in (("train", train_idx), ("val", val_idx)):
            subset = df.iloc[idx]
            entry[split_name] = subset.to_dict("records")
            if copy:
                for _, row in subset.iterrows():
                    dest = (output_root / f"fold_{fold_idx}" / split_name
                            / row["clinical_case"] / Path(row["item"]).name)
                    dest.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(row["frame_path"], dest / "frame.png")
                    for key, name in (("background_path", "background.png"),
                                      ("solid_path", "solid.png"),
                                      ("nonsolid_path", "non-solid.png"),
                                      ("fan_path", "fan.png")):
                        if isinstance(row[key], str):  # None -> NaN in pandas
                            shutil.copy2(row[key], dest / name)
        fold_index.append(entry)

    metadata = {
        "total_frames": len(df),
        "total_cases": df["clinical_case"].nunique(),
        "solid_ratio": df["has_solid"].mean(),
        "nonsolid_ratio": df["has_nonsolid"].mean(),
        "seed_used": best_seed,
        "n_splits": n_splits,
        "n_bins": n_bins,
        "balance_score": best_score,
    }
    pd.DataFrame([metadata]).to_csv(output_root / "split_metadata.csv",
                                    index=False)
    balance_df.to_csv(output_root / "fold_statistics.csv", index=False)
    if plots:
        try:
            _balance_plots(balance_df, df, output_root)
            create_visualizations(df, output_root, hist_df)
            _fold_figures(balance_df, df, output_root)
        except Exception as e:  # plotting is best-effort
            print(f"[folds] plot generation skipped: {e}")
    return fold_index, balance_df, best_seed


def _balance_plots(balance_df, df, output_root: Path):
    """Compact summary figures (this package's own addition)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    x = balance_df["fold"]
    axes[0].bar(x - 0.2, balance_df["train_frames"], 0.4, label="train")
    axes[0].bar(x + 0.2, balance_df["val_frames"], 0.4, label="val")
    axes[0].set_title("frames per fold"); axes[0].legend()
    axes[1].plot(x, balance_df["train_solid_ratio"], "o-", label="train solid")
    axes[1].plot(x, balance_df["val_solid_ratio"], "s-", label="val solid")
    axes[1].plot(x, balance_df["train_nonsolid_ratio"], "o--",
                 label="train non-solid")
    axes[1].plot(x, balance_df["val_nonsolid_ratio"], "s--",
                 label="val non-solid")
    axes[1].set_title("mask-presence ratios"); axes[1].legend(fontsize=7)
    axes[2].bar(x, balance_df["imbalance_score"])
    axes[2].set_title("imbalance score")
    fig.tight_layout()
    fig.savefig(output_root / "fold_balance.png")
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 4))
    counts = df.groupby("clinical_case").size()
    ax.hist(counts, bins=min(20, max(3, counts.nunique())))
    ax.set_title("frames per case")
    fig.tight_layout()
    fig.savefig(output_root / "dataset_analysis.png")
    plt.close(fig)


def _pct_labels(ax, values, total):
    for i, v in enumerate(values):
        ax.text(i, v, f"{v / max(total, 1) * 100:.1f}%", ha="center",
                va="bottom")


def create_visualizations(df, output_dir, hist_df=None):
    """Dataset-analysis figure set (create_visualizations,
    multiclass_StratKFold.py:55-212) — same file names, matplotlib-only
    (no seaborn dependency).

    Figures: frames_per_case_distribution, mask_type_distribution,
    mask_combinations [+ histological_distribution,
    frames_by_histological_type, mask_by_histological when hist_df given].
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    total = len(df)

    # 1. frames per clinical case (hist + mean/median lines, :65-80)
    frame_counts = df.groupby("clinical_case").size()
    fig, ax = plt.subplots(figsize=(12, 8))
    ax.hist(frame_counts, bins=min(20, max(3, frame_counts.nunique())))
    ax.axvline(frame_counts.mean(), color="r", linestyle="--",
               label=f"Mean: {frame_counts.mean():.2f}")
    ax.axvline(frame_counts.median(), color="g", linestyle="-",
               label=f"Median: {frame_counts.median():.2f}")
    ax.set_title("Distribution of Frames per Clinical Case")
    ax.set_xlabel("Number of Frames")
    ax.set_ylabel("Count of Clinical Cases")
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_dir / "frames_per_case_distribution.png")
    plt.close(fig)

    # 2. mask-type distribution with percentage labels (:81-103)
    mask_counts = {
        "Background": int(df["has_background"].sum()),
        "Solid": int(df["has_solid"].sum()),
        "Non-solid": int(df["has_nonsolid"].sum()),
        "Fan": int(df["has_fan"].sum()) if "has_fan" in df.columns else 0,
    }
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.bar(list(mask_counts), list(mask_counts.values()))
    _pct_labels(ax, list(mask_counts.values()), total)
    ax.set_title("Distribution of Mask Types")
    ax.set_ylabel("Count")
    ax.set_xlabel("Mask Type")
    fig.tight_layout()
    fig.savefig(output_dir / "mask_type_distribution.png")
    plt.close(fig)

    # 3. mask combinations sorted by count (:105-133)
    combos = df.groupby(
        ["has_background", "has_solid", "has_nonsolid"]).size().reset_index(
        name="count")
    combos["label"] = combos.apply(
        lambda x: f"BG: {'Y' if x['has_background'] else 'N'}, "
                  f"Solid: {'Y' if x['has_solid'] else 'N'}, "
                  f"Non-solid: {'Y' if x['has_nonsolid'] else 'N'}", axis=1)
    combos = combos.sort_values("count", ascending=False)
    fig, ax = plt.subplots(figsize=(14, 8))
    ax.bar(combos["label"], combos["count"])
    _pct_labels(ax, combos["count"].tolist(), total)
    ax.set_title("Combinations of Mask Types")
    ax.set_ylabel("Count")
    ax.set_xlabel("Mask Combination")
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    fig.tight_layout()
    fig.savefig(output_dir / "mask_combinations.png")
    plt.close(fig)

    # 4-6. histological figures (:137-205)
    if hist_df is not None and "histological" in hist_df.columns:
        case_hist = df[["clinical_case"]].drop_duplicates().merge(
            hist_df[["clinical_case", "histological"]], on="clinical_case",
            how="left")
        case_hist["histological"] = case_hist["histological"].fillna(
            "unknown")

        hist_counts = case_hist["histological"].value_counts()
        fig, ax = plt.subplots(figsize=(12, 8))
        ax.bar(hist_counts.index.astype(str), hist_counts.values)
        _pct_labels(ax, hist_counts.values.tolist(), len(case_hist))
        ax.set_title("Distribution of Histological Types")
        ax.set_ylabel("Count of Clinical Cases")
        ax.set_xlabel("Histological Type")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        fig.tight_layout()
        fig.savefig(output_dir / "histological_distribution.png")
        plt.close(fig)

        frames_by_hist = df.merge(case_hist, on="clinical_case")
        hist_frame_counts = frames_by_hist.groupby("histological").size()
        fig, ax = plt.subplots(figsize=(14, 8))
        ax.bar(hist_frame_counts.index.astype(str), hist_frame_counts.values)
        ax.set_title("Number of Frames by Histological Type")
        ax.set_ylabel("Count of Frames")
        ax.set_xlabel("Histological Type")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        fig.tight_layout()
        fig.savefig(output_dir / "frames_by_histological_type.png")
        plt.close(fig)

        mask_by_hist = frames_by_hist.groupby("histological").agg(
            Background=("has_background", "sum"),
            Solid=("has_solid", "sum"),
            Nonsolid=("has_nonsolid", "sum"))
        fig, ax = plt.subplots(figsize=(16, 10))
        idx = np.arange(len(mask_by_hist))
        width = 0.25
        for k, col in enumerate(("Background", "Solid", "Nonsolid")):
            ax.bar(idx + (k - 1) * width, mask_by_hist[col], width,
                   label=col.replace("Nonsolid", "Non-solid"))
        ax.set_xticks(idx)
        ax.set_xticklabels(mask_by_hist.index.astype(str), rotation=45,
                           ha="right")
        ax.set_title("Distribution of Mask Types by Histological Category")
        ax.set_ylabel("Count")
        ax.set_xlabel("Histological Type")
        ax.legend(title="Mask Type")
        fig.tight_layout()
        fig.savefig(output_dir / "mask_by_histological.png")
        plt.close(fig)

    return output_dir


def _fold_figures(balance_df, df, output_root: Path):
    """Per-fold balance figure + statistics-table figure
    (multiclass_StratKFold.py:484-566) — same file names."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(len(balance_df))
    fig, axes = plt.subplots(1, 2, figsize=(14, 8))
    for ax, kind in zip(axes, ("solid", "nonsolid")):
        overall = df[f"has_{kind}"].mean()
        ax.axhline(y=overall, color="r", linestyle="--",
                   label=f"Overall: {overall:.2f}")
        ax.bar(x - 0.2, balance_df[f"train_{kind}_ratio"], 0.4,
               color="blue", alpha=0.7, label="Train")
        ax.bar(x + 0.2, balance_df[f"val_{kind}_ratio"], 0.4,
               color="green", alpha=0.7, label="Validation")
        title = "Solid" if kind == "solid" else "Non-solid"
        ax.set_title(f"{title} Mask Ratio by Fold")
        ax.set_xlabel("Fold")
        ax.set_ylabel(f"{title} Mask Ratio")
        ax.set_xticks(x)
        ax.legend()
    fig.tight_layout()
    fig.savefig(output_root / "fold_balance_analysis.png")
    plt.close(fig)

    n_splits = len(balance_df)
    fig = plt.figure(figsize=(12, n_splits * 0.8 + 2))
    plt.axis("off")
    col_labels = ["Fold", "Train Frames", "Val Frames", "Train Solid %",
                  "Train Non-solid %", "Val Solid %", "Val Non-solid %",
                  "Imbalance Score"]
    rows = [[f"{r.fold:.0f}", f"{r.train_frames:.0f}", f"{r.val_frames:.0f}",
             f"{r.train_solid_ratio * 100:.1f}%",
             f"{r.train_nonsolid_ratio * 100:.1f}%",
             f"{r.val_solid_ratio * 100:.1f}%",
             f"{r.val_nonsolid_ratio * 100:.1f}%",
             f"{r.imbalance_score:.4f}"]
            for r in balance_df.itertuples()]
    table = plt.table(cellText=rows, colLabels=col_labels, loc="center",
                      cellLoc="center",
                      colWidths=[0.08, 0.12, 0.12, 0.13, 0.16, 0.13, 0.16,
                                 0.15])
    table.auto_set_font_size(False)
    table.set_fontsize(12)
    table.scale(1, 1.5)
    plt.title("Fold Statistics Summary", fontsize=16, pad=20)
    fig.tight_layout()
    fig.savefig(output_root / "fold_statistics_table.png")
    plt.close(fig)
