"""The data store: the local backend, its client, the packed-array blob
format and its codecs, and array transfer for torch tensors."""
