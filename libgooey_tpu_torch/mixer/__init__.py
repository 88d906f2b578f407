"""The mixer (port of libgooey_tpu/mixer): so far the reorderable effect
chain (``chain``)."""
