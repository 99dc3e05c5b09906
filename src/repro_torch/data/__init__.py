from .pipeline import SyntheticLM, TokenBatcher, make_train_iterator
