// Stand-in for the CUDA header of that name: see emu.h.
#include "emu.h"
