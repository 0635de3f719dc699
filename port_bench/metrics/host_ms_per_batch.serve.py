"""Host milliseconds a batch in ``APTAIPredictor.predict_batch``: padding,
upload and enqueueing the forward, over the window's batches (the fetch's
copy is not split from its wait on the device here)."""

import statistics


def read(obs):
    host = obs.get("host_s")
    return 1e3 * statistics.fmean(host) if host else None
