"""Top-k helpers (port of ``fashionvisualexpl_tpu/ops/topk.py``).

Only the filler id is ported so far; the streaming top-k and counts come
with evaluation.
"""

OUT_OF_RANGE_ID = 2**30  # filler id no catalog reaches
