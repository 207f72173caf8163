from acg_torch.io.mtxfile import MtxFile, read_mtx, vector_to_mtx, write_mtx

__all__ = ["MtxFile", "read_mtx", "vector_to_mtx", "write_mtx"]
