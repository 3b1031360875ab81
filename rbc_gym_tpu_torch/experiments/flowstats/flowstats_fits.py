"""Fit the flow-statistics curves: the port's copy of
``experiments/flowstats/flowstats_fits.py``.

  * Nu_max(Ra) = a * Ra^b         -- the power law behind the reward
    normaliser's constants;
  * w_max(Ra) = w_inf * Ra^n / (Ra^n + Ra_c^n) -- the Hill-type velocity
    saturation behind the 3D observation normaliser.

Both are fitted in linear space to the maxima over the last ``--tail``
steps (the statistically steady window), as the JAX script does. Reads
the pickle written by ``flowstats_ra`` (default: the port's
``flowstats_ra_torch.pkl`` beside this module), prints the fitted
constants as JSON and, with ``--plot``, renders the fits to PNG
(matplotlib, on the host). numpy and scipy only: the card has both.

Usage:
  python -m rbc_gym_tpu_torch.experiments.flowstats.flowstats_fits [--pkl FILE.pkl] \\
      [--tail 100] [--out FILE.json] [--plot]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def power_law(ra, a, b):
    return a * np.power(ra, b)


def hill(ra, w_inf, ra_c, n):
    rn = np.power(ra, n)
    return w_inf * rn / (rn + np.power(ra_c, n))


def fit(records, tail: int = 100) -> dict:
    """The fitted constants and the points they were fitted to."""
    from scipy.optimize import curve_fit

    records = sorted(records, key=lambda r: r["ra"])
    ras = np.array([r["ra"] for r in records], np.float64)
    nu = np.array([np.mean(r["nusselt"][-tail:]) for r in records], np.float64)
    nu_max = np.array([np.max(r["nusselt"][-tail:]) for r in records], np.float64)
    w_max = np.array([np.max(r["max_w"][-tail:]) for r in records], np.float64)
    (a, b), _ = curve_fit(power_law, ras, nu_max, p0=(0.2, 0.3))
    (w_inf, ra_c, n), _ = curve_fit(hill, ras, w_max, p0=(1.0, 700.0, 1.0), maxfev=20000)
    return {
        "nu_power_law": {"a": float(a), "b": float(b)},
        "w_max_hill": {"w_inf": float(w_inf), "ra_c": float(ra_c), "n": float(n)},
        "points": {
            str(int(r)): {"nu": float(x), "nu_max": float(xm), "max_w": float(w)}
            for r, x, xm, w in zip(ras, nu, nu_max, w_max)
        },
    }


def plot(result: dict, out_png: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = result["points"]
    ras = np.array([float(r) for r in pts])
    nu = np.array([p["nu"] for p in pts.values()])
    w_max = np.array([p["max_w"] for p in pts.values()])
    a, b = result["nu_power_law"]["a"], result["nu_power_law"]["b"]
    h = result["w_max_hill"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    rr = np.geomspace(ras.min(), ras.max(), 200)
    ax1.loglog(ras, nu, "o", label="measured")
    ax1.loglog(rr, power_law(rr, a, b), "-", label=f"{a:.3g} Ra^{b:.3f}")
    ax1.set_xlabel("Ra"), ax1.set_ylabel("Nu"), ax1.legend()
    ax2.semilogx(ras, w_max, "o", label="measured")
    ax2.semilogx(rr, hill(rr, h["w_inf"], h["ra_c"], h["n"]), "-",
                 label=f"Hill: w_inf={h['w_inf']:.3f}")
    ax2.set_xlabel("Ra"), ax2.set_ylabel("max |w|"), ax2.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pkl", default=os.path.join(HERE, "flowstats_ra_torch.pkl"))
    p.add_argument("--tail", type=int, default=100,
                   help="steps from the end used for the steady-state mean")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--out", default=None, help="JSON output path")
    args = p.parse_args(argv)

    with open(args.pkl, "rb") as f:
        records = pickle.load(f)
    result = fit(records, args.tail)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if args.plot:
        out_png = args.pkl.replace(".pkl", "_fits.png")
        plot(result, out_png)
        print(f"wrote {out_png}")
    return result


if __name__ == "__main__":
    main()
