"""The paper's own workload: Radic determinant of an m×n matrix.

Port of ``repro/configs/radic_paper.py``, copied as data.  Not an LM
architecture: it configures the core library and kernels for the
benchmark and driver scripts.  ``backend`` defaults to the port's
``"cuda"`` (the hand-written kernels; ``"torch"`` is the plain path)
where the reference's defaults to ``"pallas"``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RadicConfig:
    m: int = 5
    n: int = 24
    mode: str = "flat"            # flat | grains
    backend: str = "cuda"         # cuda | torch
    grains_per_device: int = 4
    chunk: int = 2048
    tile: int = 256
    kahan: bool = False


CONFIG = RadicConfig()


def smoke() -> RadicConfig:
    return RadicConfig(m=3, n=10, chunk=32, tile=16, grains_per_device=2)
