"""Plot a training run's learning curves from the port's metrics.jsonl.

Twin of ``experiments/plot_training.py``, host-only (matplotlib, imported
when it runs). It renders rollout Nusselt, evaluation Nusselt, the
losses, the entropy and the PPO diagnostics from the ``metrics.jsonl``
that ``rl.callbacks.MetricsLogger`` writes, with horizontal baselines from
``eval_baselines``' ``baseline_eval_torch.json`` where the result dir has
one, and that record's per-step Nu traces. Its figures are named
``curves_torch.png`` and ``eval_traces_torch.png``, so that they never
overwrite the JAX script's in a result dir both packages wrote to.

Usage:
  python -m rbc_gym_tpu_torch.experiments.plot_training RESULT_DIR [-o curves.png]
"""

from __future__ import annotations

import argparse
import json
import os

BASELINES = "baseline_eval_torch.json"


def read_metrics(result_dir: str) -> list:
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("result_dir")
    p.add_argument("-o", "--out", default=None,
                   help="output image (default <result_dir>/curves_torch.png)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = read_metrics(args.result_dir)

    def series(key):
        pts = [(r["iteration"], r[key]) for r in rows if key in r]
        return ([p[0] for p in pts], [p[1] for p in pts])

    bl_path = os.path.join(args.result_dir, BASELINES)
    bl = None
    if os.path.isfile(bl_path):
        with open(bl_path) as f:
            bl = json.load(f)

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    ax = axes[0, 0]
    ax.plot(*series("rollout/nusselt_mean"), label="rollout Nu (stochastic)")
    ei, ev = series("eval/nusselt")
    if ei:
        ax.plot(ei, ev, "o-", ms=3, label="eval Nu (greedy)")
    if bl is not None:
        for name, color in (("zero", "k"), ("random", "gray")):
            if name in bl:
                ax.axhline(bl[name]["nusselt_mean_second_half"], color=color,
                           ls="--", lw=1, label=f"{name}-action baseline")
    ax.set_xlabel("iteration")
    ax.set_ylabel("Nusselt")
    ax.legend(fontsize=8)
    ax.set_title("Heat transport (lower = better control)")

    ax = axes[0, 1]
    ax.plot(*series("loss"), label="total")
    ax.plot(*series("policy_loss"), label="policy")
    ax.plot(*series("value_loss"), label="value")
    ax.set_xlabel("iteration")
    ax.set_yscale("symlog")
    ax.legend(fontsize=8)
    ax.set_title("Losses")

    ax = axes[1, 0]
    ax.plot(*series("entropy"))
    ax.set_xlabel("iteration")
    ax.set_title("Policy entropy")

    ax = axes[1, 1]
    ax.plot(*series("approx_kl"), label="approx KL")
    ax.plot(*series("clip_fraction"), label="clip fraction")
    ax.set_xlabel("iteration")
    ax.legend(fontsize=8)
    ax.set_title("PPO diagnostics")

    fig.tight_layout()
    out = args.out or os.path.join(args.result_dir, "curves_torch.png")
    fig.savefig(out, dpi=130)
    plt.close(fig)
    print(f"wrote {out}")
    written = [out]

    # per-step eval Nu(t) traces (trained against the baselines), where the
    # evaluation record has them
    traces = {} if bl is None else {
        name: bl[name]["nusselt_trace"]
        for name in ("trained", "zero", "random", "proportional")
        if "nusselt_trace" in bl.get(name, {})
    }
    if traces:
        fig2, ax = plt.subplots(figsize=(8, 4.5))
        styles = {"trained": ("C0", "-"), "zero": ("k", "--"),
                  "random": ("gray", ":"), "proportional": ("C2", "-.")}
        for name, tr in traces.items():
            color, ls = styles.get(name, ("C3", "-"))
            ax.plot(tr, color=color, ls=ls, label=name)
        n = len(next(iter(traces.values())))
        ax.axvspan(n // 2, n - 1, alpha=0.08, color="C0", label="scored window (2nd half)")
        supp = bl.get("suppression_vs_zero_pct")
        ci = bl.get("suppression_vs_zero_ci95")
        title = "Held-out eval: Nu(t), mean over episodes"
        if supp is not None and ci:
            title += f"  -  suppression {supp:.1f}% [{ci[0]:.1f}, {ci[1]:.1f}]"
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("env step")
        ax.set_ylabel("Nusselt")
        ax.legend(fontsize=8)
        fig2.tight_layout()
        out2 = os.path.join(args.result_dir, "eval_traces_torch.png")
        fig2.savefig(out2, dpi=130)
        plt.close(fig2)
        print(f"wrote {out2}")
        written.append(out2)
    return written


if __name__ == "__main__":
    main()
