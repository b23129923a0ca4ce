from repro_torch.train.serve_loop import greedy_decode, make_serve_fns

__all__ = ["greedy_decode", "make_serve_fns"]
