"""SPICE metric via the coco-caption Java pipeline.

The reference averages SPICE into the densecap scores
(main.py:429-443) through the densevid_eval -> coco-caption submodule,
which shells into `spice-1.0.jar` (Java scene-graph parser).  This
module is the equivalent escape hatch: `make_spice_fn()` returns a
callable suitable for `DensecapEvaluator(spice_fn=...)` when a SPICE
jar and a java runtime are discoverable, and None otherwise (the
evaluator then reports SPICE as 0.0, exactly like running coco-caption
without the jar installed).

Discovery order for the jar: explicit argument, $SPICE_JAR, then
<data_path>/spice/spice-1.0.jar.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, List, Optional


def find_spice_jar(jar_path: Optional[str] = None,
                   data_path: str = "data") -> Optional[str]:
    candidates = [jar_path, os.environ.get("SPICE_JAR"),
                  os.path.join(data_path, "spice", "spice-1.0.jar")]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


def make_spice_fn(jar_path: Optional[str] = None,
                  data_path: str = "data",
                  java: str = "java",
                  timeout: int = 1800) -> Optional[Callable]:
    """Returns spice_fn(gts, res) -> mean SPICE F-score, or None when
    the jar or the java runtime is unavailable."""
    jar = find_spice_jar(jar_path, data_path)
    if jar is None or shutil.which(java) is None:
        return None

    def spice_fn(gts: Dict[str, List[str]],
                 res: Dict[str, List[str]]) -> float:
        # coco-caption spice.py input format: one record per item with
        # the candidate under "test" and references under "refs"
        records = [{"image_id": i, "test": res[i][0], "refs": gts[i]}
                   for i in res]
        with tempfile.TemporaryDirectory() as td:
            in_file = os.path.join(td, "spice_in.json")
            out_file = os.path.join(td, "spice_out.json")
            cache = os.path.join(td, "cache")
            os.makedirs(cache, exist_ok=True)
            with open(in_file, "w") as f:
                json.dump(records, f)
            try:
                subprocess.run(
                    [java, "-jar", "-Xmx8G", jar, in_file, "-cache",
                     cache, "-out", out_file, "-subset", "-silent"],
                    check=True, timeout=timeout)
                with open(out_file) as f:
                    results = json.load(f)
                scores = [float(item["scores"]["All"]["f"])
                          for item in results]
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired, OSError,
                    json.JSONDecodeError, KeyError, ValueError) as e:
                # a failing jar must not kill the end-of-epoch eval
                # (hours of training); degrade to 0.0 like the
                # jar-absent case
                import warnings
                warnings.warn(f"SPICE jar failed ({e!r}); scoring 0.0")
                return 0.0
        return sum(scores) / max(len(scores), 1)

    return spice_fn
