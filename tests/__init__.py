"""Test suite (a package, so `tests.helpers` resolves ahead of any
installed module named `tests`)."""
