"""IO layer of the PyTorch port: streams, the local filesystem,
InputSplit and ThreadedIter."""
