"""Seconds of input audio whose inversion completed in the window, over the
window's wall time (host clock; a call or push counts once its output is
ready, after ``torch.cuda.synchronize()``)."""


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    return sum(r.audio_s for r in run.records) / run.window_s
