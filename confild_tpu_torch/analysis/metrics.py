"""Physics-fidelity and accuracy metrics.

* per-channel MSE / rMAE over snapshot sets — the de-facto acceptance tests of
  the reference (``Analysis/cnf_inference_pub.py:144-205``, rMAE definition
  ``ConditionalNeuralField/scripts/train.py:66-69``);
* integral timescale via spatially-averaged temporal autocorrelation
  integrated (trapezoid) to the 0.05-crossing or first local minimum
  (``Analysis/calculate_integral_timescale.py:11-182``);
* energy spectra and two-point correlations — paper-level gates
  (Nature Comms 15:10416) the reference repo does not ship; implemented here
  because BASELINE.md gates on them.

The port's own copy of ``confild_tpu/analysis/metrics.py``.  It stays numpy
on host arrays: these run on fields already saved to disk, once per
evaluation, and the float64 sums match the JAX package's to the last digits.
"""

from __future__ import annotations

import numpy as np

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


# ---------------------------------------------------------------------------
# accuracy
# ---------------------------------------------------------------------------

def per_channel_mse(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """(N, ..., C) -> (C,) mean squared error per channel."""
    err = (np.asarray(pred) - np.asarray(target)) ** 2
    return err.reshape(-1, err.shape[-1]).mean(axis=0)


def per_channel_rmae(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """(N, ..., C) -> (C,): mean over samples of
    |pred-target|.mean(space) / |target|.mean(space)."""
    pred, target = np.asarray(pred), np.asarray(target)
    dims = tuple(range(1, pred.ndim - 1))
    rmae = (np.abs(pred - target).mean(axis=dims)
            / np.abs(target).mean(axis=dims))
    return rmae.mean(axis=0)


# ---------------------------------------------------------------------------
# integral timescale (reference semantics)
# ---------------------------------------------------------------------------

def temporal_autocorrelation(u_field: np.ndarray) -> np.ndarray:
    """Spatially-averaged temporal autocorrelation of (time, *space) data,
    normalized per-point by variance; lag 0 -> 1
    (reference ``calculate_integral_timescale.py:71-107``)."""
    u_field = np.asarray(u_field, np.float64)
    n_times = u_field.shape[0]
    u_mean = u_field.mean(axis=0)
    fluct = u_field - u_mean
    variance = u_field.var(axis=0)
    valid = variance > 1e-10
    if not np.any(valid):
        return np.ones(1)
    max_lag = n_times // 2
    out = np.zeros(max_lag)
    out[0] = 1.0
    for lag in range(1, max_lag):
        product = fluct[:-lag] * fluct[lag:]
        spatial = product.mean(axis=0) / (variance + 1e-10)
        out[lag] = spatial[valid].mean()
    return out


def autocorr_cutoff(avg_autocorr: np.ndarray, threshold: float = 0.05) -> int:
    """First threshold-crossing, else first local minimum, else half range
    (reference :109-131)."""
    max_lag = len(avg_autocorr)
    if np.any(avg_autocorr < threshold):
        cutoff = int(np.argmax(avg_autocorr < threshold))
    elif max_lag > 3:
        minima = np.where(
            (avg_autocorr[1:-1] < avg_autocorr[:-2])
            & (avg_autocorr[1:-1] < avg_autocorr[2:]))[0] + 1
        cutoff = int(minima[0]) if len(minima) else max_lag // 2
    else:
        cutoff = max_lag // 2
    return max(1, cutoff)


def integral_timescale(u_field: np.ndarray, output_dt: float) -> float:
    """Integral timescale of (time, *space) velocity-component data."""
    ac = temporal_autocorrelation(u_field)
    cutoff = autocorr_cutoff(ac)
    lags = np.arange(cutoff) * output_dt
    return float(_trapezoid(ac[:cutoff], lags))


# ---------------------------------------------------------------------------
# spectra / correlations
# ---------------------------------------------------------------------------

def energy_spectrum_1d(field: np.ndarray, axis: int = -1, dx: float = 1.0):
    """1-D energy spectrum along ``axis``, averaged over all other dims.

    Returns (k, E(k)) with k in cycles per unit length."""
    field = np.asarray(field, np.float64)
    field = np.moveaxis(field, axis, -1)
    n = field.shape[-1]
    fluct = field - field.mean(axis=-1, keepdims=True)
    fhat = np.fft.rfft(fluct, axis=-1)
    e = 0.5 * (np.abs(fhat) ** 2).reshape(-1, fhat.shape[-1]).mean(axis=0) / n
    k = np.fft.rfftfreq(n, d=dx)
    return k, e


def energy_spectrum_radial(field2d: np.ndarray, dx: float = 1.0):
    """Radially-binned 2-D energy spectrum of (..., H, W) snapshots averaged
    over leading dims.  Returns (k, E(k))."""
    field2d = np.asarray(field2d, np.float64)
    h, w = field2d.shape[-2:]
    fluct = field2d - field2d.mean(axis=(-2, -1), keepdims=True)
    fhat = np.fft.fft2(fluct)
    e2d = 0.5 * (np.abs(fhat) ** 2).reshape(-1, h, w).mean(axis=0) / (h * w)
    ky = np.fft.fftfreq(h, d=dx)
    kx = np.fft.fftfreq(w, d=dx)
    kmag = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    kmax = min(ky.max(), kx.max())
    nbins = min(h, w) // 2
    bins = np.linspace(0, kmax, nbins + 1)
    which = np.digitize(kmag.ravel(), bins) - 1
    e_flat = e2d.ravel()
    spectrum = np.zeros(nbins)
    for b in range(nbins):
        m = which == b
        spectrum[b] = e_flat[m].sum() if m.any() else 0.0
    k_centers = 0.5 * (bins[1:] + bins[:-1])
    return k_centers, spectrum


def two_point_correlation(field: np.ndarray, axis: int = -1):
    """Normalized two-point autocorrelation R(r) along ``axis`` (periodic,
    FFT-based), averaged over all other dims.  R(0) == 1."""
    field = np.asarray(field, np.float64)
    field = np.moveaxis(field, axis, -1)
    n = field.shape[-1]
    fluct = field - field.mean(axis=-1, keepdims=True)
    fhat = np.fft.rfft(fluct, axis=-1)
    corr = np.fft.irfft(np.abs(fhat) ** 2, n=n, axis=-1)
    corr = corr.reshape(-1, n).mean(axis=0)
    denom = corr[0] if corr[0] != 0 else 1.0
    return corr / denom


def spectra_relative_error(field_a: np.ndarray, field_b: np.ndarray,
                           axis: int = -1) -> float:
    """Relative L2 error between 1-D energy spectra of two field sets —
    the <1% gate from BASELINE.md."""
    _, ea = energy_spectrum_1d(field_a, axis)
    _, eb = energy_spectrum_1d(field_b, axis)
    return float(np.linalg.norm(ea - eb) / np.linalg.norm(eb))


def velocity_pdf(field: np.ndarray, bins: int = 81, span_sigma: float = 5.0,
                 standardize: bool = True):
    """Histogram PDF of (optionally standardized) velocity samples — the
    paper-level "turbulence statistics" comparison (Nature Comms 15:10416;
    the reference repo codes only the integral-timescale gate,
    ``Analysis/calculate_integral_timescale.py``).  Returns (centers, pdf);
    bins span +-``span_sigma`` standard deviations."""
    x = np.asarray(field, np.float64).ravel()
    if standardize:
        x = (x - x.mean()) / max(x.std(), 1e-12)
    edges = np.linspace(-span_sigma, span_sigma, bins + 1)
    pdf, _ = np.histogram(x, bins=edges, density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, pdf


def pdf_jensen_shannon(field_a: np.ndarray, field_b: np.ndarray,
                       bins: int = 81) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between the
    standardized velocity PDFs of two field sets.  0 = identical
    distributions; a scalar gate for the paper's PDF-overlay plots."""
    _, pa = velocity_pdf(field_a, bins)
    _, pb = velocity_pdf(field_b, bins)
    pa = pa / max(pa.sum(), 1e-300)
    pb = pb / max(pb.sum(), 1e-300)
    m = 0.5 * (pa + pb)

    def kl(p, q):
        mask = p > 0
        return float(np.sum(p[mask] * np.log2(p[mask] / q[mask])))

    return 0.5 * kl(pa, m) + 0.5 * kl(pb, m)
