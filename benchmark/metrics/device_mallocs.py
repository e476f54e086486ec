"""device_mallocs: the caching allocator's device allocations (``cudaMalloc``
calls, ``torch.cuda.memory_stats``'s ``num_device_alloc``) inside the
program's calls, per 1000 traced batches: the sum over the traced batches
of the difference their root spans read at enter and exit (the flagship's
``score``, an extractor's ``audio_*``). 0 on a CPU. A batch whose memory
the allocator has to ask CUDA for waits for it on the host."""

from benchmark.harness import spans


def read(ctx):
    roots = spans.roots(ctx)
    if not roots:
        return None
    return 1000.0 * sum(r.mallocs for r in roots) / len(roots)
