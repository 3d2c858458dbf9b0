"""Data plane: wav/Kaldi/RTTM I/O and the TS-VAD chunk dataset."""
