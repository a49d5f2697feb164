"""Data layer of the PyTorch port: RowBlocks and the libsvm/CSV text
parsers."""
