"""Audio seconds transcribed per second: the audio of every call that
finished (each file counted once) over the window, to the last call's end."""


def read(run):
    return run.rate("audio_s")
