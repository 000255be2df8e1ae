"""Seconds of audio transcribed per wall second over the window: every
finished recording's audio, the one in flight at the window's end
included, over the wall from the window's start to its last answer."""


def read(run):
    w = run.window
    return w.audio_s / w.wall_s if w.items else None
