"""Frames the image tower encoded (``GridScorer.encode_calls`` x
``ENCODE_CHUNK``) over the real frames of the clips scored: what the grid cover's
wrapped frames and the last chunk's padding cost the evaluator."""


def read(r):
    real, encoded = r.counters.get("real_frames"), r.counters.get("encoded_frames")
    return encoded / real if real and encoded else None
