"""Host ms the data pipeline's prefetch thread takes to featurise a batch
(the pipeline's `next()`: segment draw and mels), the mean over the
process's batches (rank 0): the program's counters `data.featurize_ns` and
`data.featurized`.  The thread's `nvw:data.featurize` spans are not read:
the benchmark's profiler records the thread that started it and
autograd's, not a thread of the program's own."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters()
    n = c.get("data.featurized")
    if not n:
        return None
    return c["data.featurize_ns"] / n / 1e6
