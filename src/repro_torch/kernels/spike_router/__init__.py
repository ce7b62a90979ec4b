# The wrappers read ``repro_torch.core`` and ``core.fabric`` imports them:
# load the core package first, whichever of the two is imported first.
import repro_torch.core  # noqa: F401
