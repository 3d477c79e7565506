"""Fill kernels: the LNW, LSW and ANW stagger fill, the BSW banded fill
and the row-sweep fill of all four aligners (CUDA for sm_90a, plain
PyTorch on CPU), and the build of every CUDA kernel.  As in the JAX
package, `fill_bucket` is the row-sweep fill.

The five exports load their modules on first use, so importing a module
of this package does not load the fills."""

import importlib

_EXPORTS = {
    "BucketFill": "fill",
    "fill_bucket": "fill",
    "fill_bucket_async": "fill",
    "fill_banded_bucket": "banded",
    "fill_banded_bucket_async": "banded",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
