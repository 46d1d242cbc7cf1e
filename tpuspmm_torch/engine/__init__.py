"""Record and roofline helpers."""
