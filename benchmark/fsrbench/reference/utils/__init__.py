"""The UNORM helpers the oracle imports (see the package docstring)."""
