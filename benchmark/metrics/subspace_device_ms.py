"""``subspace_device_ms``: device milliseconds a solve of GEMMs and
dense-solver kernels outside the apply spans (orthonormalization and
Rayleigh-Ritz), the mean over ranks."""


def read(run):
    traces = run.traces
    if not traces or not any(t["subspace_s"] for t in traces):
        return None
    return (1e3 * sum(t["subspace_s"] / t["solves"] for t in traces)
            / len(traces))
