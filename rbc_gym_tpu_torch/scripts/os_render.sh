#!/bin/bash
# Headless-render helper, the port's twin of scripts/os_render.sh.
#
# The reference needs Xvfb + PYVISTA_OFF_SCREEN because its renderers are
# pygame/VTK windows. The port renders with matplotlib/numpy into
# rgb_array buffers (rbc_gym_tpu_torch/envs/rendering.py), so no X server
# is required: this wrapper forces the headless matplotlib backend (and
# pygame's dummy video output, for render_mode="human") and runs the
# command it is given, e.g.
#   rbc_gym_tpu_torch/scripts/os_render.sh python -m rbc_gym_tpu_torch.experiments.eval_sarl OUT --render DIR
set -euo pipefail
export MPLBACKEND=Agg
export SDL_VIDEODRIVER="${SDL_VIDEODRIVER:-dummy}"
exec "$@"
