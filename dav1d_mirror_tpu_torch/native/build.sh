#!/bin/sh
# Build the native host components into the shared library named by $1
# (default: ../build/native/libdav1d_host.so beside this package).
set -e
cd "$(dirname "$0")"
out="${1:-../build/native/libdav1d_host.so}"
mkdir -p "$(dirname "$out")"
g++ -O3 -std=c++17 -shared -fPIC -fvisibility=hidden \
    -o "$out" msac.cpp ipred.cpp tilecoder.cpp recon.cpp lf.cpp
echo "built $out"
