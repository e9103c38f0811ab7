"""H,b's geometry per LM iteration under the lens: the program's
``hb_accumulate.geometry`` span (the geometry kernel's two launches or the
plain jvp; CUDA events on the card) over the window's iterations."""

from perfbench.metrics_common import stage_ms


def read(record):
    return stage_ms(record, ('hb_accumulate.geometry',), 'iterations')
