"""Deterministic, checkpointable data pipelines (the port of
:mod:`repro.data`)."""
from .pipeline import GraphStream, LMDataPipeline
