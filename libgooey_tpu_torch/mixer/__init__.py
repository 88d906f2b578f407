"""The mixer (port of libgooey_tpu/mixer): the reorderable effect chain
(``chain``), the submix graph (``graph``), the loop channels with their
WSOLA stretcher, clip grid and streamed hop loop (``stereo_buffer``,
``loop_channel``, ``wsola``, ``clip_grid``, ``stream``) and the loop
``Mixer`` (``mixer``)."""
