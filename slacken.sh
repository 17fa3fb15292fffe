#!/bin/bash
# slacken launcher (reference: slacken.sh — env-configured entry point).
#
# Environment knobs:
#   STPU_PLATFORM        force a JAX platform ('gpu', 'cpu')
#   STPU_DEVICES         default device count for --devices-capable commands
#   STPU_TMP             scratch directory (spill builds, bracken chunks)
#   JAX_COMPILATION_CACHE_DIR  persistent XLA compile cache dir (GPU only;
#                        default <checkout>/.jax_cache)
#   STPU_PIPELINE_DEPTH  in-flight device batches (default 3)
#   PYTHON               python interpreter (default: python3 on PATH)
set -euo pipefail

get_script_dir() {
  local src="${BASH_SOURCE[0]}" dir
  while [ -L "$src" ]; do
    dir="$(cd -P "$(dirname "$src")" >/dev/null 2>&1 && pwd)"
    src="$(readlink "$src")"
    [[ $src != /* ]] && src="$dir/$src"
  done
  cd -P "$(dirname "$src")" >/dev/null 2>&1 && pwd
}

STPU_HOME="$(get_script_dir)"
PYTHON="${PYTHON:-python3}"

TMPDIR="${TMPDIR:-/tmp}"
export STPU_TMP="${STPU_TMP:-$TMPDIR}"
echo "Using ${STPU_TMP} for scratch data (set STPU_TMP to override)." >&2

# run from an installed package if present, else from the source tree
if "$PYTHON" -c 'import slacken' 2>/dev/null; then
  exec "$PYTHON" -m slacken.cli "$@"
else
  exec env PYTHONPATH="$STPU_HOME${PYTHONPATH:+:$PYTHONPATH}" \
    "$PYTHON" -m slacken.cli "$@"
fi
