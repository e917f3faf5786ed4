"""Per-texel fitting over a ``(data, view)`` mesh of ranks: the JAX
package's ``brdf_tpu.parallel`` names. ``fit_texels_sharded`` is looked up
when first asked for (PEP 562): the solvers import ``parallel.mesh`` for
their cross-rank sums, and ``parallel.fit`` imports the solvers."""

from brdf_tpu_torch.parallel.mesh import make_mesh, pad_to_multiple  # noqa: F401


def __getattr__(name):
    if name == "fit_texels_sharded":
        from brdf_tpu_torch.parallel.fit import fit_texels_sharded

        return fit_texels_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
