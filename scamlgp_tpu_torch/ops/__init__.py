"""Gram assembly, masked linear algebra and the hand-written sweep kernel."""
