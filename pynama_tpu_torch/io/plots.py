"""Plotting helpers: convergence charts, drag/lift histories, shedding
frequency.

A copy of pynama_tpu/io/plots.py. The charts need matplotlib (Agg
backend, imported when a chart is drawn); shedding_frequency is numpy
only.
"""

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def loglog_error_chart(series, out_path, xlabel="N", ylabel="error"):
    """series: list of (label, x array, y array). Parity: ErrorPlotter."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for label, x, y in series:
        ax.loglog(x, y, "o-", label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    return out_path


def drag_lift_chart(times, cds, cls_, out_path):
    """Dual-axis cd/cl history. Parity: DualAxesPlotter + plot.py:16-35."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(times, cds, "b-", label="$C_D$")
    ax1.set_xlabel("time")
    ax1.set_ylabel("$C_D$", color="b")
    ax2 = ax1.twinx()
    ax2.plot(times, cls_, "r-", label="$C_L$")
    ax2.set_ylabel("$C_L$", color="r")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    return out_path


def shedding_frequency(times, cl, u_ref=1.0, d_ref=1.0, skip_fraction=0.5):
    """Dominant C_L oscillation frequency -> Strouhal number.

    Parity: plot.py:37-59 (scipy FFT of the lift history after the
    transient). Returns (frequency, strouhal).
    """
    times = np.asarray(times)
    cl = np.asarray(cl)
    n0 = int(len(times) * skip_fraction)
    t, y = times[n0:], cl[n0:]
    if len(t) < 8:
        return 0.0, 0.0
    # resample uniformly (adaptive dt makes samples non-uniform)
    tu = np.linspace(t[0], t[-1], len(t))
    yu = np.interp(tu, t, y)
    yu = yu - yu.mean()
    freqs = np.fft.rfftfreq(len(tu), d=(tu[1] - tu[0]))
    amp = np.abs(np.fft.rfft(yu))
    f = float(freqs[np.argmax(amp[1:]) + 1]) if len(amp) > 1 else 0.0
    return f, f * d_ref / u_ref
