# The port's own copy of pngloss_tpu/version.py: the port imports nothing
# of the JAX package.
__version__ = "0.1.0"

# version of the reference tool whose behavior this framework reproduces
PNGLOSS_COMPAT_VERSION = "1.0.1"
