"""Apps of the PyTorch port: the MIDI -> WAV mixer and its web service."""
