"""mfu: the model FLOPs of the window's sequences (``lm_work.py``: each
sequence's prefill and decode steps from its own prompt length and
steps, layer by layer as the configuration file states them, or by the
model's family where it states none) over the whole window and the
card's dense peak in the configuration's compute dtype, %.  None for a
run that served no tokens (the Radic service) or ran on no card."""

import numpy as np

from detbench import lm_work


def read(run):
    if not (run.tokens_prefill or run.tokens_decode) or run.window_s <= 0:
        return None
    if run.device != "cuda" or run.model is None:
        return None
    flops = 0
    pairs, counts = np.unique(run.shapes, axis=0, return_counts=True)
    for (prompt, gen), n in zip(pairs.tolist(), counts.tolist()):
        flops += n * (lm_work.prefill_flops(run.model, prompt, run.config)
                      + lm_work.decode_flops(run.model, prompt, gen,
                                             run.config))
    return 100.0 * flops / run.window_s / lm_work.peak_flops(run.model)
