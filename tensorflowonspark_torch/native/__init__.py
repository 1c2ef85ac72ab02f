"""Native C++ sources (built on demand by native_bindings)."""
