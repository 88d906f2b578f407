#include "cuda_emu.h"
