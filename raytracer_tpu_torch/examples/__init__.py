"""Examples of the library API of raytracer_tpu_torch."""
