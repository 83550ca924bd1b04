"""Acquisition functions, acquisition ascent and host-side BO datatypes."""
