"""batch_ms_p95: the 95th percentile, over every batch of the window, of
the time from the host issuing the batch to its output landing in host
memory. Each batch is timed by a pair of CUDA events, on the device's
clock: one recorded when the host issues it, one after its copy to the
host; the host's clock would be off by some half a millisecond on a batch
of a few. (``BENCHMARK.json`` names the source ``device_trace``: of the two
that an end-to-end metric may have, the device's clock.)"""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.batch_ms), 95))
