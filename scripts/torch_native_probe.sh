#!/bin/bash
# What the native C++ library (native/*.cpp) needs, on this host: the
# compiler, the libtiff / libjpeg / libpng headers and shared libraries,
# and a trial build into a temporary directory (nothing is written under
# native/). Also prints the Python stack's versions and the card.
#
#   bash scripts/torch_native_probe.sh
cd "$(dirname "$0")/.." || exit 1
g++ --version | head -1
command -v make gcc g++ c++
for h in tiffio.h jpeglib.h png.h; do
  if echo "#include <$h>" | g++ -E - >/dev/null 2>&1; then
    echo "HEADER_OK $h"
  else
    echo "HEADER_MISSING $h"
  fi
done
ldconfig -p | grep -E 'libtiff|libjpeg|libpng' || echo "no libtiff / libjpeg / libpng in ldconfig"
python -c 'import sys, torch, PIL, numpy; print(sys.version.split()[0], torch.__version__, torch.version.cuda, "Pillow", PIL.__version__, "numpy", numpy.__version__)'
python -c 'from PIL import features; print("Pillow libtiff", features.check("libtiff"), "jpg", features.check("jpg"))'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
out=$(mktemp -d)
g++ -O3 -std=c++17 -fPIC -Wall -shared -o "$out/libkeep_native.so" native/*.cpp -ljpeg -lpng -ltiff 2>&1 | grep -m3 error
echo "BUILD_RC=${PIPESTATUS[0]}"
rm -rf "$out"
