"""The plain reference: the posteriors' potentials, their true moments and
the grading metrics, in plain PyTorch and NumPy on the host.  It imports
neither JAX nor the JAX package nor anything of the port, and reads only
the raw data under ``benchmark/data`` and the configuration files."""
