"""The share of K1 card-wide's cycles its CTAs' chains spent waiting in
the grid barriers, in %: 100 x `gen.wide.wait_cycles` / `gen.wide.cta_cycles`
over the process's launches of the kernel (the program's counters, summed
on the card: csrc/wide_generate.cu's `stats`).  Nothing where the program
has no such counters."""

from benchmark import program_trace


def read(run):
    c = program_trace.counters()
    cycles = c.get("gen.wide.cta_cycles")
    if not cycles:
        return None
    return 100.0 * c["gen.wide.wait_cycles"] / cycles
