"""Seconds of the CUDA graph captures made in set-up, every card
(``render/megarender.captures``); None where none was made."""


def read(rec):
    return rec.capture_s if rec.capture_s > 0 else None
