"""Typed error hierarchy (the port's copy of whisperkit_tpu/core/errors.py;
reference: Sources/WhisperKit/Utilities/WhisperError.swift:7-37)."""

from __future__ import annotations


class WhisperKitError(Exception):
    """Base error for the framework."""


class ModelsUnavailable(WhisperKitError):
    pass


class LoadAudioFailed(WhisperKitError):
    pass


class DeviceUnavailable(WhisperKitError):
    """The CUDA device could not be initialised (core/device_probe.py)."""
