"""Atomic, async checkpointing (the port of :mod:`repro.checkpoint`)."""
from .checkpointer import Checkpointer
