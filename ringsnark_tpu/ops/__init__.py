"""Low-level compute ops: modular arithmetic, NTT (plain XLA path and the
GPU kernels' route), primes."""
