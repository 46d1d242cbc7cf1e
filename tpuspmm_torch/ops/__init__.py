"""Compute entry points: oracle, vendor baseline, dispatch API."""
