"""No run of the benchmark may load JAX or the JAX package; the plain
reference may not load the program either. Compared by whole top-level
module names."""

import os
import subprocess
import sys

from gpubench import core


def test_forbidden_by_whole_top_level_name():
    mods = ["brdf_tpu_torch", "brdf_tpu_torch.ops", "numpy", "jaxtyping", "brdf_tpu_x"]
    assert core.forbidden_modules(mods) == []
    assert core.forbidden_modules(mods + ["jax.numpy", "brdf_tpu.ops", "flax"]) == \
        ["brdf_tpu.ops", "flax", "jax.numpy"]


def _loaded(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=core.ROOT, env=env, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_and_generator_load_nothing_of_the_program():
    top = _loaded("import gpubench.reference.fit, gpubench.reference.judge, "
                  "gpubench.reference.render, gpubench.reference.problem, gpubench.traffic.scan, "
                  "gpubench.counts.k1, gpubench.counts.k5, gpubench.counts.k7, gpubench.counts.k2")
    assert not top & {"jax", "jaxlib", "flax", "brdf_tpu", "brdf_tpu_torch"}


def test_harness_loads_no_jax():
    code = ("import gpubench.run as r, gpubench.core as c, gpubench.trace, gpubench.faults\n"
            "cell = c.find_cell(c.load_manifest(), 'blinn-pixel-16led.varpro')\n"
            "e = c.entry_module(cell)\n"
            "import brdf_tpu_torch.pipeline.fit, brdf_tpu_torch.pipeline.render\n"
            "[c.metric_module(m['name']) for m in c.load_manifest()['per_layer']]")
    assert not _loaded(code) & {"jax", "jaxlib", "flax", "brdf_tpu"}
