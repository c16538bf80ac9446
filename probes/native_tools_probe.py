"""What the machine offers to build ``native/`` (cmake, ninja, a C++
compiler, and the headers of libpng, libjpeg and zlib) and which image and
plotting packages it has.

    python3 probes/native_tools_probe.py

Prints one JSON object: each tool's path and first version line (or null),
each header's path (or null), whether scipy, matplotlib, cv2 and PIL import
(with PIL's version and its libjpeg), and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

HEADERS = ("png.h", "jpeglib.h", "zlib.h")
INCLUDE_DIRS = ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu")


def first_line(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"failed: {e}"
    return (out.stdout or out.stderr).strip().splitlines()[0] if (out.stdout or out.stderr).strip() else ""


def main():
    tools = {}
    for name in ("cmake", "ninja", "c++", "g++", "gcc", "nvcc", "pkg-config"):
        path = shutil.which(name)
        tools[name] = {"path": path, "version": first_line([path, "--version"]) if path else None}
    headers = {h: next((os.path.join(d, h) for d in INCLUDE_DIRS if os.path.exists(os.path.join(d, h))), None)
               for h in HEADERS}
    packages = {m: importlib.util.find_spec(m) is not None for m in ("scipy", "matplotlib", "cv2", "PIL")}
    if packages["PIL"]:
        import PIL
        from PIL import features

        packages["PIL_version"] = PIL.__version__
        packages["PIL_libjpeg"] = {"version": features.version("jpg"),
                                   "turbo": features.check_feature("libjpeg_turbo")}
    smi = shutil.which("nvidia-smi")
    card = first_line([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"]) if smi else None
    print(json.dumps({"tools": tools, "headers": headers, "packages": packages, "card": card,
                      "python": sys.version.split()[0]}, indent=1))


if __name__ == "__main__":
    main()
