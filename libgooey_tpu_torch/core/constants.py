"""Global constants shared across the port (values of libgooey_tpu/core/constants.py).

Capacity constants mirror the reference engine's fixed sizes
(reference: src/ffi.rs:33-35,585, src/instruments/granulator.rs:13-21,
src/instruments/sampler.rs:13-14, src/mixer/mod.rs:31, src/mixer/clip_grid.rs:5-6).
"""

DEFAULT_SAMPLE_RATE = 44_100.0

#: Samples rendered per block.  512 samples is ~11.6 ms at 44.1 kHz.  All
#: recursive state is carried across blocks in the state tuples.
DEFAULT_BLOCK_SIZE = 512

#: Default parameter smoothing time (reference: src/utils/smoother.rs:7).
DEFAULT_SMOOTH_TIME_MS = 15.0

#: Smoother settle threshold (reference: src/utils/smoother.rs:131).
SMOOTHER_SETTLE_EPS = 1e-4

#: Denormal flush threshold used throughout the reference DSP
#: (e.g. src/effects/plate_reverb.rs:90-95).
DENORMAL_EPS = 1e-15

# --- capacity constants (reference ABI) ---
SEQUENCER_STEPS = 16          # steps per pattern (src/engine/sequencer.rs)
NUM_LFOS = 8                  # src/ffi.rs:33
LFO_ROUTES_PER_LFO = 16       # src/ffi.rs:34
NUM_DRUM_CHANNELS = 4         # DrumKit strips (src/ffi.rs:670-775)
NUM_LOOP_CHANNELS = 4         # src/mixer/mod.rs:31
CLIP_GRID_COLS = 4            # src/mixer/clip_grid.rs:5
CLIP_GRID_ROWS = 8            # src/mixer/clip_grid.rs:6
POLY_VOICES = 8               # src/instruments/poly_synth.rs NUM_VOICES
GRAIN_POOL = 64               # src/instruments/granulator.rs:13
GRAIN_RELEASE_POOL = 16       # src/instruments/granulator.rs:21
SAMPLER_SLOTS = 16            # src/instruments/sampler.rs:13
SAMPLER_VOICES = 32           # src/instruments/sampler.rs:14
SAMPLER_RACK_MAX = 4          # src/ffi.rs:585
MIDI_EVENT_CAPACITY = 64      # src/ffi.rs:69-71
